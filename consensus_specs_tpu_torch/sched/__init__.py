"""Host-side scheduling of device work (the port's copy of the JAX
package's ``sched/``, as far as the BLS flush needs it)."""
from .bucketing import plan_flush, pow2_bucket

__all__ = ["plan_flush", "pow2_bucket"]
