"""Time this checkout's K5-K8 kernels in turns with another checkout's.

    python3 kernel_turns.py DIR [--seed 0] [--kernels fq_pow,...] [--sizes 1,130,...]

DIR is another checkout of the repo, say the parent commit unpacked by
``git archive``. Its ``fq_pow.cu`` and ``curve.cu`` (and the headers they
include) are compiled by nvcc into ``build/turns/`` with this checkout's
flags, each kernel symbol renamed ``<name>_parent_kernel`` so that the
profiler tells the two apart, and called through this checkout's C launch
signatures (``fq_cuda.POW_ARGTYPES``/``CURVE_ARGTYPES``): the script
refuses a DIR whose ``extern "C"`` declarations differ from this
checkout's. At 1 element, at a BLS flush's 130 and 260 and at a
decode's 16,385, each pair first agrees bit for bit on the same inputs,
then both are timed in turns (``chip_smoke.device_ms_turns``): K5 with
(p - 1) / 2 and (p + 1) / 4, K6 with (p - 1) / 2, K7/K8 by |x|;
``--kernels`` keeps the named ones, ``--sizes`` takes other element
counts. A variant of a kernel is timed the same way, from a copy of this
checkout with the variant's edit as DIR.

Prints a line a kernel and size, the card's name and power limit, and last
one JSON object of the device ms a launch, this checkout's and DIR's. Needs
one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from consensus_specs_tpu_torch.ops import cuda_build, fq, fq_cuda, fq_plain  # noqa: E402
from consensus_specs_tpu_torch.ops import curve_torch as cj  # noqa: E402
from consensus_specs_tpu_torch.ops import ladder_checks as lc  # noqa: E402

CSRC = Path("consensus_specs_tpu_torch") / "ops" / "csrc"
# source -> (headers, kernels, error-string function, launch argument types)
SOURCES = {
    "fq_pow.cu": (("fq.cuh",), ("fq_pow", "fq2_pow"), "fq_pow_error_string", fq_cuda.POW_ARGTYPES),
    "curve.cu": (("fq.cuh", "curve.cuh"), ("g1_mul_static", "g2_mul_static"), "curve_error_string",
                 fq_cuda.CURVE_ARGTYPES),
}
SIZES = "1,130,260,16385"


def c_api(path: Path) -> dict:
    """The functions declared in ``path``'s ``extern "C"`` block: name ->
    return type and parameters, whitespace collapsed."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    found = re.findall(r"^(int|const char\*) (\w+)\(([^)]*)\)", block, re.M)
    return {name: " ".join(f"{ret} ({params})".split()) for ret, name, params in found}


def build_parent(parent: Path, source: str) -> ctypes.CDLL:
    headers, names, _, _ = SOURCES[source]
    csrc = parent / CSRC
    ours, theirs = c_api(ROOT / CSRC / source), c_api(csrc / source)
    smoke.require(ours == theirs, f"{csrc / source} declares another C API than this checkout's: {theirs} != {ours}")
    defines = [f"-D{name}_kernel={name}_parent_kernel" for name in names]
    h = hashlib.sha256(b"".join((csrc / f).read_bytes() for f in (source, *headers)))
    h.update(" ".join(cuda_build.NVCC_FLAGS + defines).encode())
    lib = cuda_build.BUILD_DIR.parent / "turns" / f"lib{Path(source).stem}_parent_{h.hexdigest()[:16]}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *defines, "-Xptxas", "-v", "-o", str(lib), str(csrc / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        smoke.require(proc.returncode == 0, f"nvcc {csrc / source} failed ({proc.returncode}):\n{proc.stderr}")
        print(f"[build] {csrc / source}:\n" + "\n".join(
            line for line in proc.stderr.splitlines() if "registers" in line or "spill" in line), flush=True)
    return ctypes.CDLL(str(lib))


def parent_kernels(parent: Path, keep: list) -> dict:
    """name -> DIR's build of the kernels in ``keep`` of K5-K8, called as
    this checkout's wrapper is: a tensor and the exponent's bits, or a
    Jacobian point and k."""
    calls = {}
    for source, (_, names, error_fn, argtypes) in SOURCES.items():
        if not set(names) & set(keep):
            continue
        lib = build_parent(parent, source)
        for name in names:
            launch = getattr(lib, f"{name}_launch")
            launch.argtypes, launch.restype = argtypes, ctypes.c_int
            calls[name] = _call(lib, launch, name, error_fn)
        getattr(lib, error_fn).restype = ctypes.c_char_p
    return calls


def _call(lib, launch, name: str, error_fn: str):
    degree = 2 if name in ("fq2_pow", "g2_mul_static") else 1

    def run(ins: list, bits) -> list:
        words, length = fq_cuda._exponent(bits)
        ins = [t.contiguous() for t in ins]
        outs = [torch.empty_like(t) for t in ins]
        rc = launch(*(t.data_ptr() for t in ins + outs), ins[0].numel() // (degree * fq.N_LIMBS), words, length,
                    torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's {name} launch failed: {getattr(lib, error_fn)(rc).decode()}")
        return outs

    if name in smoke.POW:
        return lambda a, bits: run([a], bits)[0]
    return lambda pt, k: tuple(run(list(pt), fq_plain.bits_msb(k)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, help="another checkout of the repo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="fq_pow,fq2_pow,g1_mul_static,g2_mul_static")
    ap.add_argument("--sizes", default=SIZES, help="element counts, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    keep, sizes = args.kernels.split(","), [int(n) for n in args.sizes.split(",")]
    old = parent_kernels(args.parent.resolve(), keep)
    rng = np.random.default_rng([args.seed, 10])
    cases = []
    for name, k in smoke.POW.items():
        for exponent in k["turns"]:
            bits = fq_plain.bits_msb(fq_plain.EXPONENTS[exponent])
            for n in sizes:
                a, _ = smoke.pow_operand(n, k["degree"], rng, edges=False)
                cases.append((name, f"{exponent}, {n}", lambda f, a=a, bits=bits: f(a, bits), k["kernel"]))
    for name, spec in smoke.LADDER.items():
        for n in sizes:
            pt, _ = lc.ladder_points(n, spec["g2"], rng, "cuda", distinct=8)
            cases.append((name, str(n), lambda f, pt=pt: f(pt, cj.X_PARAM), spec["kernel"]))
    out = {}
    for name, n, call, new in (c for c in cases if c[0] in keep):
        got, want = call(new), call(old[name])
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(smoke.max_abs_err(x, y) for x, y in zip(got, want))
        smoke.require(err == 0, f"{name} disagrees with the parent's at {n} (max abs err {err})")
        ms = smoke.device_ms_turns({f"{name}_kernel": lambda: call(new),
                                    f"{name}_parent_kernel": lambda: call(old[name])}, reps=6)
        rec = out.setdefault(name, {})[n] = {"ms": ms[f"{name}_kernel"], "parent_ms": ms[f"{name}_parent_kernel"]}
        print(f"[turns] {name} at {n} elements: {rec['ms'] * 1e3:.1f} us on the card, the other side's "
              f"{rec['parent_ms'] * 1e3:.1f} us ({rec['ms'] / rec['parent_ms']:.3f}x), bit-exact", flush=True)
    print(smoke.nvidia_smi("name,power.limit"))
    print(json.dumps({"parent": str(args.parent), "turns": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
