"""Host-side scheduling of device work (the port's copy of the JAX
package's ``sched/``, as far as the port needs it): the BLS flush planner
and the generator's overlapped case writer."""
from .bucketing import plan_flush, pow2_bucket
from .writer import CaseWriter

__all__ = ["plan_flush", "pow2_bucket", "CaseWriter"]
