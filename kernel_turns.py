"""Time the port's K3-K9 kernels in turns: with the work they replaced, or
with another checkout's builds of K5-K8.

    python3 kernel_turns.py [--seed 0]
    python3 kernel_turns.py DIR [--seed 0] [--kernels fq_pow,...] [--sizes 1,130,...]

With no DIR, the comparisons in turns that ``chip_smoke.py`` ran as its
timing phase until it kept one profiler window per kernel: K3/K4's
lane-group and one-thread kernels in turns, one profiler window per size,
at 4,608 and 16,384 elements and at each kernel's two most frequent sizes
of a flush, beside the bound and the launch floor (the probe's device
time). K5/K6 at every size a flush launched them (and at 1 element, for
the latency of one product), in turns with the same chain as a loop of
K3/K4 launches: device time and wall time a chain. K7/K8 likewise by |x|,
at 1 point and every size a flush launched them, in turns with the ladder
as a loop of K3/K4 launches. K9 at 1 element, every size a flush launched
it and 16,385, in turns with K5 at p - 2 (the chain it replaced), beside a
bound from its SASS per pipe. The flush's launch-size histogram is read
from ``build/smoke_flush.json``, which ``chip_smoke.py`` writes (run it
first, in the same call).

With DIR, another checkout of the repo, say the parent commit unpacked by
``git archive``: its ``fq_pow.cu``, ``curve.cu`` and ``fr_fft.cu`` (and the
headers they include) are compiled by nvcc into ``build/turns/`` with this
checkout's flags, each kernel symbol renamed ``<name>_parent_kernel`` so
that the profiler tells the two apart, and called through this checkout's
C launch signatures (``fq_cuda.POW_ARGTYPES``/``CURVE_ARGTYPES``,
``fr_cuda.MUL_ARGTYPES``/``FFT_ARGTYPES``): the script refuses a DIR whose
``extern "C"`` declarations differ from this checkout's. At 1 element, at
a BLS flush's 130 and 260 and at a decode's 16,385 (``--sizes``), and for
K11/K12 at 1,024 and at the FFT entry points' 16,384 and 32,768, each
pair first agrees bit for bit on the same inputs, then both are timed in
turns (``chip_smoke.device_ms_turns``): K5 with (p - 1) / 2 and (p + 1) /
4, K6 with (p - 1) / 2, K7/K8 by |x|, K12 as the product, K11 as a
forward transform (device time of all its launches, each side's launches
a transform counted by the profiler); ``--kernels`` keeps the named
ones. A variant of a kernel is timed the same way, from a
copy of this checkout with the variant's edit as DIR.

Prints a line a kernel and size, the card's name and power limit, and last
one JSON object of the results. Needs one CUDA card; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from chip_smoke import (  # noqa: E402
    FQ_BYTES, FQ_SIZES, FQ_SYMBOLS, K3_INT_OPS, K4_INT_OPS, K9_ROUNDS, K9_SASS, LADDER, POW, P_MINUS_2_BITS,
    chain_work, cuda_ms, device_ms_turns, field_pairs, fq_plain_op, fq_variants, ladder_work, pow_operand,
    resident_int_ops, sass_pipes, traced,
)
from consensus_specs_tpu_torch.ops import cuda_build, fq, fq_cuda, fq_plain, fr_cuda, fr_plain, tower  # noqa: E402
from consensus_specs_tpu_torch.ops import curve_torch as cj  # noqa: E402
from consensus_specs_tpu_torch.ops import ladder_checks as lc  # noqa: E402

CSRC = Path("consensus_specs_tpu_torch") / "ops" / "csrc"
# source -> (headers, kernels, error-string function, launch argument types)
SOURCES = {
    "fq_pow.cu": (("fq.cuh",), ("fq_pow", "fq2_pow"), "fq_pow_error_string", fq_cuda.POW_ARGTYPES),
    "curve.cu": (("fq.cuh", "curve.cuh"), ("g1_mul_static", "g2_mul_static"), "curve_error_string",
                 fq_cuda.CURVE_ARGTYPES),
}
# K11/K12's source -> (headers, kernel symbols <name>_kernel); its launchers
# take other arguments than K5-K8's (fr_cuda.MUL_ARGTYPES/FFT_ARGTYPES)
FR_SOURCES = {"fr_fft.cu": (("fr.cuh",), ("fr_mul", "fr_fft_pass"))}
SIZES = "1,130,260,16385"
FR_SIZES = (1024, 16384, 32768)
FR_KERNELS = ("fr_fft", "fr_mul")


def c_api(path: Path) -> dict:
    """The functions declared in ``path``'s ``extern "C"`` block: name ->
    return type and parameters, whitespace collapsed."""
    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    found = re.findall(r"^(int|const char\*) (\w+)\(([^)]*)\)", block, re.M)
    return {name: " ".join(f"{ret} ({params})".split()) for ret, name, params in found}


def build_parent(parent: Path, source: str, headers: tuple, names: tuple) -> ctypes.CDLL:
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
    for source, (headers, names, error_fn, argtypes) in SOURCES.items():
        if not set(names) & set(keep):
            continue
        lib = build_parent(parent, source, headers, names)
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


def parent_fr(parent: Path) -> dict:
    """DIR's build of K11/K12, called as this checkout's wrappers call
    theirs: ``fr_mul(a, b)`` the product of (n, 22) rows, ``fr_fft(x, n)``
    the forward transform."""
    lib = build_parent(parent, "fr_fft.cu", *FR_SOURCES["fr_fft.cu"])
    lib.fr_mul_launch.argtypes, lib.fr_mul_launch.restype = fr_cuda.MUL_ARGTYPES, ctypes.c_int
    lib.fr_fft_launch.argtypes, lib.fr_fft_launch.restype = fr_cuda.FFT_ARGTYPES, ctypes.c_int
    lib.fr_error_string.argtypes, lib.fr_error_string.restype = [ctypes.c_int], ctypes.c_char_p

    def check(rc: int, name: str) -> None:
        if rc != 0:
            raise RuntimeError(f"the parent's {name} launch failed: {lib.fr_error_string(rc).decode()}")

    def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = torch.empty_like(a)
        check(lib.fr_mul_launch(a.data_ptr(), fr_plain.N_LIMBS, b.data_ptr(), fr_plain.N_LIMBS, out.data_ptr(),
                                a.shape[0], fr_cuda.OP_MUL, torch.cuda.current_stream().cuda_stream), "fr_mul")
        return out

    def fft(x: torch.Tensor, n: int) -> torch.Tensor:
        tw, scale = fr_cuda.fft_constants(n, False, x.device)
        words = torch.empty((n, fr_cuda.N_WORDS), dtype=torch.int32, device=x.device)
        out = torch.empty_like(x)
        check(lib.fr_fft_launch(x.data_ptr(), words.data_ptr(), out.data_ptr(), tw.data_ptr(), n, n.bit_length() - 1,
                                scale, 0, torch.cuda.current_stream().cuda_stream), "fr_fft")
        return out

    return {"fr_mul": mul, "fr_fft": fft}


def launches_a_call(fn, symbol: str, reps: int = 4, windows: int = 2) -> int:
    """The launches of kernels whose name holds ``symbol`` that one call of
    ``fn`` makes, as the profiler counts them over ``reps`` calls: the most
    of ``windows`` windows, since CUPTI may drop events but adds none."""
    def run():
        for _ in range(reps):
            fn()

    seen = max(sum(e.count for e in traced(run) if symbol in e.key) for _ in range(windows))
    smoke.require(seen > 0, f"the profiler saw no launch of {symbol}")
    return round(seen / reps)


def fr_turns(parent: Path, keep: list, seed: int) -> dict:
    """K11/K12 against DIR's build at each of ``FR_SIZES``: bit-exact on the
    same inputs first, then device time in turns (K11: the transform, all
    its launches' device time)."""
    old = parent_fr(parent)
    rng = np.random.default_rng([seed, 15])
    out = {}
    for n in FR_SIZES:
        a, b = (torch.from_numpy(fr_plain.to_limbs(smoke.fr_ints(n, rng))).cuda() for _ in range(2))
        x = fr_plain.to_mont(a)
        calls = {"fr_mul": (lambda: fr_cuda.fr_mul(a, b), lambda: old["fr_mul"](a, b)),
                 "fr_fft": (lambda: fr_cuda.fr_fft(x, n), lambda: old["fr_fft"](x, n))}
        for name in (k for k in FR_KERNELS if k in keep):
            new, prev = calls[name]
            got, want = new(), prev()
            torch.cuda.synchronize()
            err = smoke.max_abs_err(got, want)
            smoke.require(err == 0, f"{name} disagrees with the parent's at {n} (max abs err {err})")
            symbol = "fr_fft_pass" if name == "fr_fft" else name
            mine, theirs = f"{symbol}_kernel", f"{symbol}_parent_kernel"
            sides = {mine: new, theirs: prev}
            per_call = {k: launches_a_call(fn, k) for k, fn in sides.items()}
            want_launches = fr_cuda.fft_passes(n) if name == "fr_fft" else 1
            smoke.require(per_call[mine] == want_launches,
                          f"{name} at {n}: the profiler counted {per_call[mine]} launches a call, not {want_launches}")
            ms = smoke.device_ms_turns(sides, reps=6, per_call=per_call)
            rec = out.setdefault(name, {})[str(n)] = {
                "ms": ms[mine] * per_call[mine], "parent_ms": ms[theirs] * per_call[theirs],
                "launches": per_call[mine], "parent_launches": per_call[theirs]}
            print(f"[turns] {name} at {n} elements: {rec['ms'] * 1e3:.2f} us on the card in {rec['launches']} "
                  f"launches, the other side's {rec['parent_ms'] * 1e3:.2f} us in {rec['parent_launches']} "
                  f"({rec['ms'] / rec['parent_ms']:.3f}x), bit-exact", flush=True)
    return out


def loop_chain(name: str, a: torch.Tensor, bits: list) -> torch.Tensor:
    """The chain as the main path ran it before K5/K6: one K3 launch a
    product (Fq), or the tower's squaring and product on K3/K4 (Fq2)."""
    if name == "fq_pow":
        r = fq.const(fq.ONE_MONT, a.device).expand(a.shape)
        for bit in bits:
            r = fq_cuda.fq_mul(r, r)
            if bit:
                r = fq_cuda.fq_mul(r, a)
        return r
    r = fq.const(tower.ONE2, a.device).expand(a.shape)
    for bit in bits:
        r = tower.fq2_square(r)
        if bit:
            r = tower.fq2_mul(r, a)
    return r


def loop_turns(symbol: str, new, old, reps: int, windows: int = 3) -> dict:
    """A kernel (``new``: a call that launches it once; ``symbol``: a
    substring of its name) in turns with ``old``, the loop of K3/K4
    launches it replaced: device time from one profiler window (the
    loop's: every kernel it launched, copies included), and wall time a
    call on the host's clock, from its call to its result, in a second
    round of turns without the profiler. CUPTI may drop events: a window
    that saw fewer than half of the kernel's launches or 90% of the
    loop's K3/K4 launches is measured again, up to ``windows`` times."""
    before = sum(fq_cuda.launches[k] for k in ("fq_mul", "fq_addsub"))
    old()
    per_loop = sum(fq_cuda.launches[k] for k in ("fq_mul", "fq_addsub")) - before

    def run():
        for r in range(reps):
            for fn in (new, old) if r % 2 == 0 else (old, new):
                fn()

    for _ in range(windows):
        events = traced(run)
        ours = [e for e in events if symbol in e.key]
        base = [e for e in events if "fq_mul_lanes" in e.key or "fq_addsub_lanes" in e.key]
        seen, seen_base = sum(e.count for e in ours), sum(e.count for e in base)
        if seen >= max(1, reps // 2) and seen_base >= 0.9 * reps * per_loop:
            break
        print(f"[profiler] saw {seen} of {reps} {symbol} launches, {seen_base} of {reps * per_loop} K3/K4", flush=True)
    else:
        raise AssertionError(f"the profiler saw too few launches in {windows} windows")
    ours_us = sum(e.self_device_time_total for e in ours)
    scale = reps * per_loop / seen_base  # the loop's launches made / seen: the profiler may drop some
    wall = {"new": 0.0, "old": 0.0}
    for r in range(reps):
        for key, fn in (("new", new), ("old", old)) if r % 2 == 0 else (("old", old), ("new", new)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[key] += (time.perf_counter() - t0) * 1e3 / reps
    return {"ms": ours_us / seen / 1e3,
            "loop_device_ms": (sum(e.self_device_time_total for e in events) - ours_us) / 1e3 / reps * scale,
            "loop_k3k4_device_ms": sum(e.self_device_time_total for e in base) / 1e3 / reps * scale,
            "loop_launches": per_loop, "wall_ms": wall["new"], "loop_wall_ms": wall["old"]}


def phase_fq_timing(report: dict, card: "Card", seed: int, hist: dict) -> None:
    """K3/K4's lane-group and one-thread kernels timed in turns, one
    profiler window per size, at 4,608 and 16,384 elements and at each
    kernel's two most frequent sizes of a flush (``hist``: elements ->
    launches), beside the bound and the launch floor; K4 as op 1 (sub).
    Each kernel's record is taken at its most frequent size."""
    rng = np.random.default_rng(seed + 1)
    floor = report["probe"]["ms"]
    out = {}
    for name, op, ops in (("fq_mul", "mul", K3_INT_OPS), ("fq_addsub", "sub", K4_INT_OPS)):
        top = sorted(hist[name], key=lambda n: (-hist[name][n], n))[:2]
        variants = fq_variants(op)
        by_size = {}
        for n in dict.fromkeys(top + FQ_SIZES):
            a, b, _, _ = field_pairs(n, rng, edges=False)
            ms = device_ms_turns({f"{name}_{FQ_SYMBOLS[k]}_kernel": (lambda f=f: f(a, b)) for k, f in variants.items()})
            ms = {k: ms[f"{name}_{FQ_SYMBOLS[k]}_kernel"] for k in variants}
            bound, bound_by = card.bound_ms(n, ops, FQ_BYTES * n)
            by_size[n] = {"ms": ms, "bound_ms": bound, "bound_by": bound_by, "flush_launches": hist[name].get(n, 0)}
            print(f"[fq_timing] {name} at {n} elements ({hist[name].get(n, 0)} launches a flush): "
                  + ", ".join(f"{k} {v * 1e3:.3f} us" for k, v in ms.items())
                  + f"; bound {bound * 1e3:.3f} us ({bound_by}), launch floor {floor * 1e3:.3f} us", flush=True)
        n = top[0]
        a, b, _, _ = field_pairs(n, rng, edges=False)
        plain_ms = cuda_ms(lambda: fq_plain_op(op, a, b), reps=5)
        for variant, fn in variants.items():
            out[name if variant == "main" else f"{name}_{variant}"] = {
                "elements": n, "measurement_only": variant != "main", "ms": by_size[n]["ms"][variant],
                "call_ms": cuda_ms(lambda: fn(a, b)), "plain_ms": plain_ms, "bound_ms": by_size[n]["bound_ms"],
                "bound_by": by_size[n]["bound_by"], "floor_ms": floor, "library_ms": None, "by_size": by_size,
            }
    report["fq_timing"] = out


def phase_pow_timing(report: dict, card: "Card", seed: int, hist: dict) -> None:
    """K5/K6 at 1 element and at every size a flush launched them (``hist``:
    elements -> launches), for each exponent of their turns, each in turns
    with the loop of K3/K4 launches it replaced, beside its bounds:
    operations (``resident_int_ops`` of the chain's products and sums,
    times n), bytes (each element read and written once), the launch floor,
    and a latency estimate: the chain's depth in product rounds x one
    product's latency, read from K5 at 1 element. For K5 that is its own
    time at 1 element, a floor for it at larger n as K7/K8's is; for K6 it
    is an estimate only, since K6's round (a batch of sums and products on
    two subgroups, then a shuffle) is not K5's lone product, and nothing
    shows it takes at least as long. Each kernel's record is taken at its
    most frequent size with its timed exponent, with its time per round."""
    rng = np.random.default_rng([seed, 7])
    floor = report["probe"]["ms"]
    out, product_ms = {}, None
    for name, k in POW.items():
        by_exponent = {}
        for exponent in k["turns"]:
            e = fq_plain.EXPONENTS[exponent]
            bits = fq_plain.bits_msb(e)
            products, sums, serial, depth = chain_work(name, e)
            by_size = by_exponent[exponent] = {}
            for n in dict.fromkeys([1] + sorted(hist[name])):
                a, _ = pow_operand(n, k["degree"], rng, edges=False)
                t = loop_turns(f"{name}_kernel", lambda: k["kernel"](a, bits), lambda: loop_chain(name, a, bits),
                               reps=4 if n > 1 else 6)
                if name == "fq_pow" and n == 1 and exponent == k["timed"]:
                    product_ms = t["ms"] / depth
                bound, bound_by = card.bound_ms(n, resident_int_ops(products, sums, k["degree"]),
                                                2 * 128 * k["degree"] * n)
                by_size[n] = {**t, "bound_ms": bound, "bound_by": bound_by,
                              "latency_estimate_ms": depth * product_ms, "flush_launches": hist[name].get(n, 0),
                              "serial": serial, "rounds": depth, "us_per_round": t["ms"] * 1e3 / depth}
                print(f"[pow_timing] {name} at {n} elements ({hist[name].get(n, 0)} launches a flush, {exponent}): "
                      f"{t['ms'] * 1e3:.1f} us on the card, {t['wall_ms']:.3f} ms a chain; the loop of "
                      f"{t['loop_launches']} K3/K4 launches {t['loop_device_ms'] * 1e3:.1f} us on the card "
                      f"({t['loop_k3k4_device_ms'] * 1e3:.1f} in K3/K4), {t['loop_wall_ms']:.3f} ms a chain; bound "
                      f"{bound * 1e3:.2f} us ({bound_by}), latency estimate {depth * product_ms * 1e3:.1f} us "
                      f"({products} products, {serial} serial, {depth} rounds: "
                      f"{t['ms'] * 1e3 / depth:.3f} us a round), launch floor {floor * 1e3:.3f} us", flush=True)
        n = sorted(hist[name], key=lambda v: (-hist[name][v], v))[0]
        bits = fq_plain.bits_msb(fq_plain.EXPONENTS[k["timed"]])
        a, _ = pow_operand(n, k["degree"], rng, edges=False)
        timed = by_exponent[k["timed"]]
        out[name] = {"elements": n, "exponent": k["timed"], "plain_ms": cuda_ms(lambda: k["plain"](a, bits), reps=2),
                     "library_ms": None, "floor_ms": floor, "by_size": timed, "by_exponent": by_exponent,
                     **{key: timed[n][key] for key in ("ms", "bound_ms", "bound_by", "latency_estimate_ms",
                                                       "serial", "rounds", "us_per_round")}}
    report["pow_timing"] = out


def phase_inv_timing(report: dict, card: "Card", seed: int, hist: dict) -> None:
    """K9 at 1 element, at every size a flush launched it (``hist``) and at
    16,385, in turns with K5 at p - 2 (the chain it replaced) in one
    profiler window, beside its bounds: operations (the SASS counts of
    ``sass_pipes`` times n), bytes (each element read and written once), the launch floor, and the
    latency floor: its own time at 1 element (one thread's chain of
    dependent steps, the card otherwise idle). The record is taken at its
    most frequent flush size."""
    rng = np.random.default_rng([seed, 12])
    floor = report["probe"]["ms"]
    by_size = {}
    sass = sass_pipes(fq_cuda.build_inv(), K9_SASS, trips=K9_ROUNDS, loops=1)
    print(f"[inv_timing] fq_inv SASS an element: {sass['alu']} ALU, {sass['fma']} FMA, {sass['issue']} issued; "
          f"bound by {sass['bound_by_pipe']}: {sass['histogram']}", flush=True)
    for n in dict.fromkeys([1] + sorted(hist["fq_inv"]) + [16385]):
        a, _ = pow_operand(n, 1, rng, edges=False)
        ms = device_ms_turns({"fq_inv_kernel": lambda: fq_cuda.fq_inv(a),
                              "fq_pow_kernel": lambda: fq_cuda.fq_pow(a, P_MINUS_2_BITS)}, reps=6)
        bound, bound_by = card.sass_bound_ms(n, sass, 2 * 128 * n)
        by_size[n] = {"ms": ms["fq_inv_kernel"], "k5_p_minus_2_ms": ms["fq_pow_kernel"],
                      "ratio": ms["fq_inv_kernel"] / ms["fq_pow_kernel"], "bound_ms": bound, "bound_by": bound_by,
                      "latency_floor_ms": by_size[1]["ms"] if n > 1 else ms["fq_inv_kernel"],
                      "flush_launches": hist["fq_inv"].get(n, 0)}
        r = by_size[n]
        print(f"[inv_timing] fq_inv at {n} elements ({r['flush_launches']} launches a flush): {r['ms'] * 1e3:.1f} us "
              f"on the card; K5 at p - 2 in turns {r['k5_p_minus_2_ms'] * 1e3:.1f} us ({r['ratio']:.3f}x); bound "
              f"{bound * 1e3:.3f} us ({bound_by}), latency floor "
              f"{r['latency_floor_ms'] * 1e3:.1f} us, launch floor {floor * 1e3:.3f} us", flush=True)
    n = sorted(hist["fq_inv"], key=lambda v: (-hist["fq_inv"][v], v))[0]
    a, _ = pow_operand(n, 1, rng, edges=False)
    report["inv_timing"] = {"fq_inv": {
        "elements": n, "plain_ms": cuda_ms(lambda: fq_plain.pow_bits(a, P_MINUS_2_BITS), reps=2),
        "library_ms": None, "floor_ms": floor, "by_size": by_size, "sass": sass,
        **{key: by_size[n][key] for key in ("ms", "bound_ms", "bound_by", "latency_floor_ms", "k5_p_minus_2_ms")}}}


def phase_ladder_timing(report: dict, card: "Card", seed: int, hist: dict) -> None:
    """K7/K8 by |x| at 1 element and at every size a flush launched them
    (``hist``: elements -> launches), each in turns with the loop of K3/K4
    launches it replaced (``curve_torch.ladder`` on FQ/FQ2), beside its
    bounds: operations (``resident_int_ops`` of ``ladder_work``'s products
    and sums, times n), bytes (each point read and written once), the
    launch floor, and the latency floor: the kernel's own time at 1
    element, where a ladder is one dependent chain of products on one group
    and the card has nothing else to run. That floor is self-referential:
    it bounds the kernel at larger n, and says nothing of whether one
    ladder is slow. Each kernel's record is taken at its most frequent
    size."""
    rng = np.random.default_rng([seed, 9])
    floor = report["probe"]["ms"]
    k = cj.X_PARAM
    out = {}
    for name, spec in LADDER.items():
        g2 = spec["g2"]
        products, sums, serial, rounds = ladder_work(g2, k)
        by_size = {}
        for n in dict.fromkeys([1] + sorted(hist[name])):
            pt, _ = lc.ladder_points(n, g2, rng, "cuda", distinct=8)
            t = loop_turns(f"{name}_kernel", lambda: spec["kernel"](pt, k), lambda: cj.ladder(spec["F"], pt, k),
                           reps=4 if n > 1 else 6)
            bound, bound_by = card.bound_ms(n, resident_int_ops(products, sums, 3 * (1 + g2)),
                                            6 * 128 * (1 + g2) * n)
            by_size[n] = {**t, "bound_ms": bound, "bound_by": bound_by,
                          "latency_floor_ms": (by_size[1] if n > 1 else t)["ms"],
                          "flush_launches": hist[name].get(n, 0), "serial": serial, "rounds": rounds,
                          "us_per_round": t["ms"] * 1e3 / rounds}
            r = by_size[n]
            print(f"[ladder_timing] {name} at {n} elements ({r['flush_launches']} launches a flush): "
                  f"{r['ms'] * 1e3:.1f} us on the card, {r['wall_ms']:.3f} ms a ladder; the loop of "
                  f"{t['loop_launches']} K3/K4 launches {t['loop_device_ms'] * 1e3:.1f} us on the card "
                  f"({t['loop_k3k4_device_ms'] * 1e3:.1f} in K3/K4), {t['loop_wall_ms']:.3f} ms a ladder; bound "
                  f"{bound * 1e3:.2f} us ({bound_by}; {products} products, {sums} sums; {serial} serial, {rounds} "
                  f"batched rounds: {r['us_per_round']:.3f} us a round), latency floor "
                  f"{r['latency_floor_ms'] * 1e3:.1f} us, launch floor {floor * 1e3:.3f} us", flush=True)
        n = sorted(hist[name], key=lambda v: (-hist[name][v], v))[0]
        pt, _ = lc.ladder_points(n, g2, rng, "cuda", distinct=8)
        out[name] = {"elements": n, "plain_ms": cuda_ms(lambda: cj.scalar_mul_static_plain(spec["F"], pt, k), reps=2),
                     "library_ms": None, "floor_ms": floor, "by_size": by_size,
                     **{key: by_size[n][key] for key in ("ms", "bound_ms", "bound_by", "latency_floor_ms", "serial",
                                                         "rounds", "us_per_round")}}
    report["ladder_timing"] = out


def timings(seed: int) -> dict:
    """The comparisons in turns of K3-K9 at the sizes of the flush recorded
    in ``chip_smoke.FLUSH_RECORD``, as the smoke ran them."""
    flush = smoke.FLUSH_RECORD
    smoke.require(flush.exists(), f"{flush} is missing: run chip_smoke.py first, in the same call")
    record = json.loads(flush.read_text())
    hist = {k: {int(n): c for n, c in v.items()} for k, v in record["hist"].items()}
    report = {}
    card = smoke.Card()
    smoke.phase_env(report, card)
    print(f"[turns] the flush's histogram from {flush} (recorded on {record['card']})", flush=True)
    phase_fq_timing(report, card, seed, hist)
    phase_pow_timing(report, card, seed, hist)
    phase_inv_timing(report, card, seed, hist)
    phase_ladder_timing(report, card, seed, hist)
    return {k: report[k] for k in ("fq_timing", "pow_timing", "inv_timing", "ladder_timing")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path, nargs="?", help="another checkout of the repo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="fq_pow,fq2_pow,g1_mul_static,g2_mul_static,fr_fft,fr_mul")
    ap.add_argument("--sizes", default=SIZES, help="element counts, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.parent is None:
        out = timings(args.seed)
        print(smoke.nvidia_smi("name,power.limit"))
        print(json.dumps(out, default=str))
        return 0
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
    if set(FR_KERNELS) & set(keep):
        out.update(fr_turns(args.parent.resolve(), keep, args.seed))
    print(smoke.nvidia_smi("name,power.limit"))
    print(json.dumps({"parent": str(args.parent), "turns": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
