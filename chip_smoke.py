"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--validators 524288] [--slots 4]

Phases, each raising on any mismatch:

0. build: nvcc for sm_90a on every source of ops/csrc (sha256.cu, fq.cu,
   probe.cu), one process each, all started together.
1. env: torch/CUDA versions, the card's name and power limit; the liveness
   probe (probe.cu, ``x + 1`` on (8, 128) int32) against its plain version.
2. kernels: K1 (sha256_blocks) and K2 (sha256_raw_blocks) on 2^20 random
   blocks, bit-exact against their plain PyTorch versions on the card and
   against hashlib on a sample; merkle_reduce / merkle_levels / item_roots
   over 2^20 chunks against loops of the plain version. K3 (fq_mul) and K4
   (fq_addsub) on random canonical field elements at the BLS path's sizes,
   bit-exact against their plain versions and against Python integers on
   a sample. CUDA-event times beside each kernel's bound.
3. state_root: a mainnet-preset phase0 BeaconState of ``--validators``
   validators with real keys (pubkey(i) = (i + 1) G1); hash_tree_root on
   the device hasher and on the host (hashlib) must agree, with >= 90% of
   the hashed bytes through the kernels.
4. transition: ``--slots`` blocks, each carrying the previous slot's
   attestations, built on the host hasher with BLS off; the device-hasher
   state runs them through ``state_transition(validate_result=True)`` and
   must reach the host's post-state root at every slot.
5. bls: ``--slots`` more blocks, each with MAX_ATTESTATIONS = 128 signed
   aggregates (every committee of the previous slot as two halves) and a
   signed proposer and randao reveal, built on the host. The device state
   runs each under a deferred BLS verifier with the torch backend on the
   card: ONE flush per block verifies its ~130 checks (pubkey decode,
   signature decompression, hash-to-G2, aggregation, Miller loops, final
   exponentiation, all on K3/K4). Every row must hold, a sample of rows
   must be decided the same by the host oracle, and the post-state root
   must equal the host's at every slot. Each flush is timed from its call
   to its last result (checks/s); the first is traced under torch.profiler
   for the card's busy share. Then a tampered block (one
   attestation signed over another message): the card must reject exactly
   that row, the host oracle must agree, and the transition must raise on
   replay.

Prints the whole report as one ``[report]`` JSON line, then one JSON line
of kernel records, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from consensus_specs_tpu_torch import harness, probe  # noqa: E402
from consensus_specs_tpu_torch.crypto import bls  # noqa: E402
from consensus_specs_tpu_torch.crypto.bls import ciphersuite  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_torch, fq, fq_cuda, fq_plain  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256 as dev  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256_cuda, sha256_plain  # noqa: E402
from consensus_specs_tpu_torch.specs import build_spec  # noqa: E402

SOURCE = "consensus_specs_tpu_torch/ops/csrc/sha256.cu"
FQ_SOURCE = "consensus_specs_tpu_torch/ops/csrc/fq.cu"
PROBE_SOURCE = "consensus_specs_tpu_torch/ops/csrc/probe.cu"
# 32-bit integer instructions per message, counted from the round
# structure of csrc/sha256.cu: a round is 6 funnel-shift rotates, 4 LOP3
# (two 3-way XORs, choose, majority) and 4 adds (14); a scheduled word is
# 4 rotates/shifts, 2 LOP3 and 2 IADD3 (10); 8 feed-forward adds per
# compression; 24 byte permutes for the swaps.
K2_INT_OPS = 64 * 14 + 48 * 10 + 8 + 24  # data block only: 1,408
K1_INT_OPS = K2_INT_OPS + 64 * 14 + 8  # plus the constant padding block: 2,312
# 32-bit integer instructions per field element, counted from csrc/fq.cuh.
# K3: the CIOS loop is 12 x 12 operand steps and 12 x 12 reduction steps,
# each a 32 x 32 -> 64-bit multiply (2: low and high halves) and two 64-bit
# adds (4), so 6 a step: 1,728; plus 12 m = t0 * n0' multiplies, the
# conditional subtraction (12 subtract-with-borrow, 12 selects) and the
# repacking of two operands in (8 limbs -> 3 words: 10 shift/or each group,
# 40 an operand) and one result out (16 shift/and a group, 64): 1,908.
K3_INT_OPS = 2 * 144 * 6 + 12 + 24 + 2 * 40 + 64
# K4: a 12-word add or subtract with carries (24), the conditional
# subtraction or add-back of p (24 + 12), and the same repacking (144): 204.
K4_INT_OPS = 24 + 36 + 2 * 40 + 64
FQ_BYTES = 3 * 4 * 32  # two (32,) int32 operands read, one written
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 results per clock


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


class Card:
    def __init__(self):
        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.int_ops_per_s = self.sms * INT32_LANES_PER_SM * self.max_sm_mhz * 1e6

    def bound_ms(self, messages: int, ops_per_message: int, nbytes: int) -> tuple:
        ops_ms = messages * ops_per_message / self.int_ops_per_s * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` on the card, from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of one launch of ``kernel`` (a substring of its
    symbol) over the launches the profiler saw in ``reps`` calls of
    ``fn``. A small kernel's CUDA-event time per call is the host's time
    to enqueue it; this is the time the card spends in it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA]
    count = sum(e.count for e in events)  # CUPTI may drop an event at a buffer edge
    require(count >= reps // 2, f"the profiler saw {count} launches of {kernel} in {reps} calls")
    return sum(e.self_device_time_total for e in events) / count / 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build(report: dict) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        libs = list(pool.map(lambda build: build(verbose=True), (sha256_cuda.build, fq_cuda.build, probe.build)))
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {SOURCE}, {FQ_SOURCE}, {PROBE_SOURCE} in {report['build_s']:.1f}s: "
          f"{[lib.name for lib in libs]}", flush=True)


def phase_env(report: dict, card: "Card") -> None:
    report["env"] = {
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": nvidia_smi("name,power.limit"),
    }
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {report['env']['card']}", flush=True)
    probe.reset_counters()
    result = probe.probe()  # the probe's main path: one launch, held against x + 1
    launches = probe.launches["add_one"]
    x = torch.arange(8 * 128, dtype=torch.int32, device="cuda").view(8, 128)
    got = probe.add_one(x)
    err = max_abs_err(got, probe.add_one_plain(x))
    require(err == 0, f"add_one disagrees with its plain version (max abs err {err})")
    ms = device_ms(lambda: probe.add_one(x), "add_one_kernel")
    call_ms = cuda_ms(lambda: probe.add_one(x))
    plain_ms = cuda_ms(lambda: probe.add_one_plain(x))
    library_ms = cuda_ms(lambda: torch.add(x, 1))
    bound, bound_by = card.bound_ms(x.numel(), 1, 8 * x.numel())
    report["probe"] = {
        "launches": launches, "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by, **result,
    }
    print(f"[env] probe add_one (8, 128): ok, {ms:.4f} ms on the card, {call_ms:.4f} ms a call "
          f"(plain {plain_ms:.4f}, torch.add {library_ms:.4f}, "
          f"bound {bound:.6f} {bound_by})", flush=True)


def phase_fq_kernels(report: dict, card: "Card", seed: int) -> None:
    """K3/K4 at the BLS path's sizes: 128 * 2 * 18 products (an Fq12
    multiply of a block's 128 two-pair Miller loops) and 16,384 (one
    pubkey decode of a block's attesters)."""
    rng = np.random.default_rng(seed)
    p = fq.P_INT
    out = {}
    for n in (128 * 2 * 18, 16384):
        vals = [int.from_bytes(rng.bytes(48), "big") % p for _ in range(2 * n)]
        a = torch.from_numpy(fq.to_limbs(vals[:n])).cuda()
        b = torch.from_numpy(fq.to_limbs(vals[n:])).cuda()
        sample = list(range(0, n, n // 64))
        rinv = pow(1 << 384, -1, p)
        for name, ops, kern, plain, want_int in (
            ("fq_mul", K3_INT_OPS, fq_cuda.fq_mul, fq_plain.mul, lambda x, y: x * y * rinv % p),
            ("fq_addsub", K4_INT_OPS, lambda x, y: fq_cuda.fq_addsub(x, y, 1),
             lambda x, y: fq_plain.addsub(x, y, 1), lambda x, y: (x - y) % p),
        ):
            got, want = kern(a, b), plain(a, b)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(err == 0, f"{name} disagrees with its plain version at {n} (max abs err {err})")
            ints = fq.from_limbs(got[sample].cpu().numpy())
            require(list(ints) == [want_int(vals[i], vals[n + i]) for i in sample],
                    f"{name} disagrees with Python integers")
            if name == "fq_addsub":  # the other two op codes, bit-exact too
                for op in (0, 2):
                    e = max_abs_err(fq_cuda.fq_addsub(a, b, op), fq_plain.addsub(a, b, op))
                    require(e == 0, f"fq_addsub op {op} disagrees with its plain version")
            ms = device_ms(lambda: kern(a, b), f"{name}_kernel")
            call_ms = cuda_ms(lambda: kern(a, b))
            plain_ms = cuda_ms(lambda: plain(a, b), reps=5)
            bound, bound_by = card.bound_ms(n, ops, FQ_BYTES * n)
            rec = {"elements": n, "max_abs_err": err, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
            out.setdefault(name, rec)  # the first size, the Fq12 multiply, is the record's
            out[f"{name}@{n}"] = rec
            print(f"[kernels] {name}: {n} elements {ms:.4f} ms on the card, {call_ms:.4f} ms a call, "
                  f"plain {plain_ms:.3f} ms, "
                  f"bound {bound:.5f} ms ({bound_by})", flush=True)
    report["kernels"].update(out)


def phase_kernels(report: dict, card: Card, seed: int, k2_rows: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << 20
    blocks = torch.randint(-(2**31), 2**31, (n, 16), dtype=torch.int32, device="cuda", generator=g)
    sample = blocks[:4096].cpu().numpy().tobytes()
    out = {}
    for name, ops, rows in (("sha256_blocks", K1_INT_OPS, n), ("sha256_raw_blocks", K2_INT_OPS, k2_rows)):
        kern, plain = getattr(sha256_cuda, name), getattr(sha256_plain, name)
        got, want = kern(blocks), plain(blocks)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        require(err == 0, f"{name} disagrees with its plain version (max abs err {err})")
        digests = got[:4096].cpu().numpy().tobytes()
        if name == "sha256_blocks":
            ref = b"".join(hashlib.sha256(sample[64 * i : 64 * i + 64]).digest() for i in range(4096))
            require(digests == ref, f"{name} disagrees with hashlib")
        x = blocks[:rows]
        ms = cuda_ms(lambda: kern(x))
        plain_ms = cuda_ms(lambda: plain(x), reps=3)
        bound, bound_by = card.bound_ms(rows, ops, 96 * rows)
        out[name] = {
            "rows": rows, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "gb_per_s": 64 * rows / ms / 1e6,
        }
        print(f"[kernels] {name}: {rows} rows {ms:.4f} ms ({64 * rows / ms / 1e6:.1f} GB/s of input), "
              f"plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    # K2 against hashlib: pad 4096 short messages on the host as the seam does
    msgs = [bytes(sample[64 * i : 64 * i + 37]) for i in range(4096)]
    require(dev.hash_small_device(msgs) == [hashlib.sha256(m).digest() for m in msgs],
            "sha256_raw_blocks disagrees with hashlib")

    chunks = blocks.view(-1, 8)[:n]
    levels = 20

    def plain_loop(c, k):
        out = []
        for _ in range(k):
            c = sha256_plain.sha256_blocks(c.reshape(-1, 16))
            out.append(c)
        return out

    want_levels = plain_loop(chunks, levels)
    got_levels = dev.merkle_levels(chunks, levels)
    require(all(torch.equal(a, b) for a, b in zip(got_levels, want_levels)), "merkle_levels disagrees")
    require(torch.equal(dev.merkle_reduce(chunks, levels), want_levels[-1][0]), "merkle_reduce disagrees")
    require(torch.equal(dev.item_roots(chunks, 3), want_levels[2]), "item_roots disagrees")
    reduce_ms = cuda_ms(lambda: dev.merkle_reduce(chunks, levels))
    bound, bound_by = card.bound_ms(n - 1, K1_INT_OPS, 32 * n + 32)
    out["merkle_reduce"] = {"chunks": n, "ms": reduce_ms, "bound_ms": bound, "bound_by": bound_by}
    print(f"[kernels] merkle_reduce 2^20 chunks: {reduce_ms:.4f} ms (bound {bound:.4f} ms)", flush=True)
    report["kernels"] = out


def state_root_phase(report: dict, spec, states: tuple) -> dict:
    dev_state, host_state = states
    dev.use_device_hasher(calibrate=False)
    dev.reset_counters()
    t0 = time.perf_counter()
    root = spec.hash_tree_root(dev_state)
    device_s = time.perf_counter() - t0
    counts = dev.counters()
    dev.use_host_hasher()
    t0 = time.perf_counter()
    host_root = spec.hash_tree_root(host_state)
    host_s = time.perf_counter() - t0
    require(root == host_root, f"state root differs: device {root.hex()} host {host_root.hex()}")
    kernel_bytes = sum(counts["kernel_bytes"].values())
    share = kernel_bytes / (kernel_bytes + counts["host_bytes"])
    require(share >= 0.9, f"only {share:.1%} of the hashed bytes went through the kernels")
    report["state_root"] = {
        "root": root.hex(), "device_s": device_s, "host_s": host_s, "counts": counts,
        "kernel_share": share, "kernel_bytes_per_s": kernel_bytes / device_s,
    }
    print(f"[state_root] {root.hex()} device {device_s:.3f}s host {host_s:.3f}s, "
          f"{share:.4%} of {kernel_bytes + counts['host_bytes']} bytes through the kernels, "
          f"launches {counts['launches']}", flush=True)
    return counts


def device_busy_s(prof) -> float:
    total_us = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += getattr(e, "self_device_time_total", 0.0)
    return total_us / 1e6


def transition_phase(report: dict, spec, states: tuple, slots: int) -> dict:
    dev_state, host_state = states
    bls.bls_active = False
    blocks, host_roots, host_times = [], [], []
    for _ in range(slots):  # the host run builds the blocks
        t0 = time.perf_counter()
        blocks.append(harness.next_block(spec, host_state))
        host_times.append(time.perf_counter() - t0)
        host_roots.append(spec.hash_tree_root(host_state))
    require(all(len(b.message.body.attestations) > 0 for b in blocks), "a block carries no attestation")
    dev.use_device_hasher(calibrate=False)
    # the device run computes its own shuffles and active sets
    spec._shuffle_cache.clear()
    spec._active_indices_cache.clear()
    dev.reset_counters()
    dev_times = []
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ) as prof:
        for sb, want in zip(blocks, host_roots):
            t0 = time.perf_counter()
            spec.state_transition(dev_state, sb, validate_result=True)
            torch.cuda.synchronize()
            dev_times.append(time.perf_counter() - t0)
            got = spec.hash_tree_root(dev_state)
            require(got == want, f"slot {int(dev_state.slot)}: device root {got.hex()} host {want.hex()}")
    counts = dev.counters()
    dev.use_host_hasher()
    busy = device_busy_s(prof)
    report["transition"] = {
        "slots": slots, "attestations": [len(b.message.body.attestations) for b in blocks],
        "device_slot_s": dev_times, "host_slot_s": host_times, "counts": counts,
        "device_busy_s": busy, "device_idle_share": 1 - busy / sum(dev_times),
        "slots_per_s": slots / sum(dev_times),
    }
    print(f"[transition] {slots} slots, attestations {report['transition']['attestations']}, "
          f"device s/slot {[round(t, 3) for t in dev_times]}, host build s/slot "
          f"{[round(t, 3) for t in host_times]}, device busy {busy:.4f}s, launches {counts['launches']}",
          flush=True)
    return counts


def _oracle_rows(verifier, start: int, end: int) -> list:
    """At least 4 rows of a block for the host oracle: its two Verify
    rows (proposer, randao) and its first and last FastAggregateVerify."""
    keys = verifier.entries[start:end]
    v = [i for i, k in enumerate(keys) if k[0] == "v"]
    fav = [i for i, k in enumerate(keys) if k[0] == "fav"]
    return sorted(set(v[:2] + fav[:1] + fav[-1:]))


def _oracle(key) -> bool:
    if key[0] == "v":
        return ciphersuite.Verify(key[1], key[2], key[3])
    return ciphersuite.FastAggregateVerify(list(key[1]), key[2], key[3])


class TimedVerifier(bls.DeferredVerifier):
    """A deferred verifier whose flush is timed on the host's clock, from
    its call to its last result on the card, and, with ``trace``, traced
    under torch.profiler (CUDA activity only, to keep the tracer's own cost
    off the host path): the card's busy time is the sum of its kernels'
    device times."""

    def __init__(self, trace: bool = False):
        super().__init__()
        self.trace, self.flush_s, self.profiled = trace, 0.0, None

    def flush(self) -> None:
        torch.cuda.synchronize()
        if not self.trace:
            t0 = time.perf_counter()
            super().flush()
            torch.cuda.synchronize()
            self.flush_s += time.perf_counter() - t0
            return
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            super().flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        self.flush_s += wall
        busy = device_busy_s(prof)
        kernels = sum(e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA)
        self.profiled = {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
                         "kernels": kernels}


def bls_phase(report: dict, spec, states: tuple, slots: int, seed: int) -> dict:
    """Signed blocks of 128 aggregates, one deferred flush each on the card.
    The first block's flush is traced; checks/s is read from the others."""
    dev_state, host_state = states
    bls.bls_active = True
    blocks, host_roots, host_times = [], [], []
    for _ in range(slots):  # the host run builds and signs the blocks
        t0 = time.perf_counter()
        blocks.append(harness.next_block(spec, host_state, split=True, sign=True))
        host_times.append(time.perf_counter() - t0)
        host_roots.append(spec.hash_tree_root(host_state))
    n_att = [len(b.message.body.attestations) for b in blocks]
    # every committee of the previous slot as two halves: 2 x 64 = 128 at 2^19 validators
    full = min(spec.MAX_ATTESTATIONS, 2 * int(spec.get_committee_count_per_slot(host_state, 0)))
    require(all(n == full for n in n_att), f"blocks carry {n_att} attestations, not {full} each")
    bls.use_backend("torch")
    dev.use_device_hasher(calibrate=False)
    spec._shuffle_cache.clear()
    spec._active_indices_cache.clear()
    dev.reset_counters()
    fq_cuda.reset_counters()
    per_block = []
    for i, (sb, want) in enumerate(zip(blocks, host_roots)):
        bls_torch.reset_stage_seconds()
        before = dict(fq_cuda.launches)
        decoded = bls_torch._pubkeys().decoded
        t0 = time.perf_counter()
        verifier = harness.apply_block_deferred(spec, dev_state, sb, verifier=TimedVerifier(trace=i == 0))
        torch.cuda.synchronize()
        block_s = time.perf_counter() - t0
        got = spec.hash_tree_root(dev_state)
        require(got == want, f"slot {int(dev_state.slot)}: device root {got.hex()} host {want.hex()}")
        checks = len(set(verifier.entries))
        flush_s = verifier.flush_s
        t0 = time.perf_counter()
        sampled = _oracle_rows(verifier, 0, verifier.mark())
        for j in sampled:
            require(_oracle(verifier.entries[j]) == verifier.results[j],
                    f"slot {int(dev_state.slot)}: host oracle disagrees on row {j}")
        oracle_s = time.perf_counter() - t0
        rec = {
            "slot": int(dev_state.slot), "checks": checks, "rows_true": sum(verifier.results),
            "block_s": block_s, "flush_s": flush_s, "checks_per_s": checks / flush_s,
            "stage_s": dict(bls_torch.stage_seconds), "stage_sum_s": sum(bls_torch.stage_seconds.values()),
            "traced": verifier.profiled is not None, "pubkeys_decoded": bls_torch._pubkeys().decoded - decoded,
            "launches": {k: fq_cuda.launches[k] - before[k] for k in fq_cuda.KERNELS},
            "oracle_rows": len(sampled), "oracle_s": oracle_s,
        }
        if i == 0:
            rec["profiled"] = verifier.profiled
            print(f"[bls] traced flush: {verifier.profiled['wall_s']:.3f}s wall, card busy "
                  f"{verifier.profiled['device_busy_s']:.4f}s (idle {verifier.profiled['device_idle_share']:.4%}), "
                  f"{verifier.profiled['kernels']} kernels", flush=True)
            rec["floors"] = floor_probe(verifier)
        per_block.append(rec)
        print(f"[bls] slot {rec['slot']}: {checks} checks all true, block {block_s:.3f}s, flush {flush_s:.3f}s "
              f"({rec['checks_per_s']:.1f} checks/s{', traced' if rec['traced'] else ''}; stages sum to "
              f"{rec['stage_sum_s']:.3f}s), stages "
              f"{ {k: round(v, 3) for k, v in rec['stage_s'].items()} }, K3/K4 launches {rec['launches']}, "
              f"{rec['pubkeys_decoded']} pubkeys decoded, oracle agrees on {len(sampled)} rows", flush=True)
    counts = dev.counters()
    launches = {k: sum(r["launches"][k] for r in per_block) for k in fq_cuda.KERNELS}
    timed = [r for r in per_block if not r["traced"]] or per_block
    report["bls"] = {
        "slots": slots, "attestations": n_att, "host_build_s": host_times, "blocks": per_block,
        "launches": launches, "sha256_counts": counts,
        "flush_device_idle_share": per_block[0]["profiled"]["device_idle_share"],
        "checks_per_s": sum(r["checks"] for r in timed) / sum(r["flush_s"] for r in timed),
    }
    print(f"[bls] {slots} signed blocks of {n_att[0]} attestations verified on the card; "
          f"{report['bls']['checks_per_s']:.2f} checks/s over the untraced flushes; K3/K4 launches {launches}; "
          f"card idle {report['bls']['flush_device_idle_share']:.4%} of the traced flush", flush=True)
    return {"launches": {**counts["launches"], **launches}}


def floor_probe(verifier) -> dict:
    """The planner's key floor, measured: the block's rows again (pubkeys
    warm) as ONE call (the card's floor, 128 keys) and as the two calls a
    floor of 1 key makes (the 1-key Verify rows, the 128-key rows)."""
    rows = [(list(k[1]) if k[0] == "fav" else [k[1]], k[2], k[3]) for k in dict.fromkeys(verifier.entries)]

    def run(groups):
        t0 = time.perf_counter()
        for g in groups:
            bls_torch.fast_aggregate_verify_batch_cold(*zip(*g))
        return time.perf_counter() - t0

    one = run([rows])
    two = run([[r for r in rows if len(r[0]) == 1], [r for r in rows if len(r[0]) > 1]])
    print(f"[bls] floors: the block's {len(rows)} rows warm as one call {one:.3f}s, as two calls {two:.3f}s",
          flush=True)
    return {"one_call_s": one, "two_calls_s": two, "rows": len(rows)}


def tampered_phase(report: dict, spec, states: tuple, seed: int) -> None:
    """One attestation signed over another message: exactly its row fails
    on the card, the host oracle agrees, and the replay raises."""
    dev_state, host_state = states
    pre = dev_state.copy()
    good = harness.next_block(spec, host_state, split=True, sign=True)
    index = (37 * seed + 5) % len(good.message.body.attestations)
    bad = harness.tampered_copy(spec, host_state, good, index)
    verifier = bls.DeferredVerifier()
    t0 = time.perf_counter()
    try:
        harness.apply_block_deferred(spec, dev_state, bad, pre_state=pre, verifier=verifier)
    except AssertionError as e:
        require("replayed transition accepted" not in str(e), str(e))
        raised = type(e).__name__
    else:
        raise AssertionError("the tampered block was accepted")
    seconds = time.perf_counter() - t0
    false_rows = [j for j, r in enumerate(verifier.results) if not r]
    att = bad.message.body.attestations[index]
    require(len(false_rows) == 1, f"{len(false_rows)} rows rejected, not exactly the tampered one")
    key = verifier.entries[false_rows[0]]
    require(key[0] == "fav" and key[3] == bytes(att.signature), "the rejected row is not the tampered attestation")
    require(_oracle(key) is False, "the host oracle accepts the tampered attestation")
    other = next(j for j, k in enumerate(verifier.entries) if k[0] == "fav" and j != false_rows[0])
    require(_oracle(verifier.entries[other]) is True, "the host oracle rejects an untampered attestation")
    report["tampered"] = {"attestation": index, "rows": len(verifier.entries), "rejected": false_rows,
                          "raised": raised, "seconds": seconds}
    print(f"[bls] tampered block: attestation {index} alone rejected of {len(verifier.entries)} rows, "
          f"host oracle agrees, replay raised {raised} ({seconds:.3f}s)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validators", type=int, default=1 << 19)
    ap.add_argument("--slots", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    report: dict = {"args": vars(args)}
    t_start = time.perf_counter()
    phase_build(report)
    card = Card()
    phase_env(report, card)
    spec = build_spec("phase0", "mainnet")
    n_blocks = (args.validators + 255) // 256
    k2_rows = spec.SHUFFLE_ROUND_COUNT * (1 + n_blocks)  # the shuffle's one sha256_many_small call
    phase_kernels(report, card, args.seed, k2_rows)
    phase_fq_kernels(report, card, args.seed)

    print("[calibrate]", json.dumps(dev.use_device_hasher(calibrate=True)), flush=True)
    dev.use_host_hasher()

    bls.bls_active = False
    t0 = time.perf_counter()
    keys = harness.pubkeys(args.validators)
    report["keys_s"] = time.perf_counter() - t0
    dev.use_device_hasher(calibrate=False)
    genesis = harness.genesis(spec, args.validators)
    states = (genesis, genesis.copy())
    dev.use_host_hasher()
    report["setup_s"] = time.perf_counter() - t0
    require(genesis.validators[len(keys) - 1].pubkey == keys[-1], "genesis does not carry the derived keys")
    print(f"[setup] {args.validators} keys in {report['keys_s']:.1f}s; genesis and a copy in "
          f"{report['setup_s']:.1f}s", flush=True)

    root_counts = state_root_phase(report, spec, states)
    transition_counts = transition_phase(report, spec, states, args.slots)
    bls_counts = bls_phase(report, spec, states, args.slots, args.seed)
    tampered_phase(report, spec, states, args.seed)
    bls.use_reference()
    dev.use_host_hasher()
    report["total_s"] = time.perf_counter() - t_start

    records = []
    for name, replaces, source in (
        ("sha256_blocks", "consensus_specs_tpu/ops/sha256_pallas.py:45", SOURCE),
        ("sha256_raw_blocks", "consensus_specs_tpu/ops/sha256.py:122", SOURCE),
        ("fq_mul", "consensus_specs_tpu/ops/fq.py:175", FQ_SOURCE),
        ("fq_addsub", "consensus_specs_tpu/ops/fq.py:115", FQ_SOURCE),
        ("add_one", "tools/pallas_probe.py:46", PROBE_SOURCE),
    ):
        if name == "add_one":
            k, launches = report["probe"], report["probe"]["launches"]
        else:
            k = report["kernels"][name]
            launches = sum(c["launches"].get(name, 0) for c in (root_counts, transition_counts, bls_counts))
        require(launches > 0, f"{name} was not launched on the main path")
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    print("[report]", json.dumps(report, default=str))
    print(json.dumps({
        "kernels": records,
        "state_root_s": report["state_root"]["device_s"],
        "state_root_host_s": report["state_root"]["host_s"],
        "kernel_share": report["state_root"]["kernel_share"],
        "slots_per_s": report["transition"]["slots_per_s"],
        "device_idle_share": report["transition"]["device_idle_share"],
        "bls_checks_per_s": report["bls"]["checks_per_s"],
        "bls_flush_device_idle_share": report["bls"]["flush_device_idle_share"],
        "total_s": report["total_s"],
    }))
    print(report["env"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
