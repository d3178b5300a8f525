"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--validators 524288] [--slots 4]

Phases, each raising on any mismatch:

1. env: torch/CUDA versions, the card's name and power limit.
2. kernels: builds csrc/sha256.cu with nvcc for sm_90a; K1 (sha256_blocks)
   and K2 (sha256_raw_blocks) on 2^20 random blocks, bit-exact against
   their plain PyTorch versions on the card and against hashlib on a
   sample; merkle_reduce / merkle_levels / item_roots over 2^20 chunks
   against loops of the plain version. CUDA-event times beside each
   kernel's bound.
3. state_root: a mainnet-preset phase0 BeaconState of ``--validators``
   validators; hash_tree_root on the device hasher and on the host
   (hashlib) must agree, with >= 90% of the hashed bytes through the kernels.
4. transition: ``--slots`` blocks, each carrying the previous slot's
   attestations, built on the host hasher; the device-hasher state runs
   them through ``state_transition(validate_result=True)`` and must reach
   the host's post-state root at every slot.

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
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from consensus_specs_tpu_torch import harness  # noqa: E402
from consensus_specs_tpu_torch.crypto import bls  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256 as dev  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256_cuda, sha256_plain  # noqa: E402
from consensus_specs_tpu_torch.specs import build_spec  # noqa: E402

SOURCE = "consensus_specs_tpu_torch/ops/csrc/sha256.cu"
# 32-bit integer instructions per message, counted from the round
# structure of csrc/sha256.cu: a round is 6 funnel-shift rotates, 4 LOP3
# (two 3-way XORs, choose, majority) and 4 adds (14); a scheduled word is
# 4 rotates/shifts, 2 LOP3 and 2 IADD3 (10); 8 feed-forward adds per
# compression; 24 byte permutes for the swaps.
K2_INT_OPS = 64 * 14 + 48 * 10 + 8 + 24  # data block only: 1,408
K1_INT_OPS = K2_INT_OPS + 64 * 14 + 8  # plus the constant padding block: 2,312
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


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_env(report: dict) -> None:
    report["env"] = {
        "python": sys.version.split()[0], "torch": torch.__version__, "cuda": torch.version.cuda,
        "card": nvidia_smi("name,power.limit"),
    }
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} on {report['env']['card']}", flush=True)


def phase_kernels(report: dict, card: Card, seed: int, k2_rows: int) -> None:
    t0 = time.perf_counter()
    sha256_cuda.build(verbose=True)
    print(f"[kernels] built {SOURCE} in {time.perf_counter() - t0:.1f}s", flush=True)
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
    phase_env(report)
    card = Card()
    spec = build_spec("phase0", "mainnet")
    n_blocks = (args.validators + 255) // 256
    k2_rows = spec.SHUFFLE_ROUND_COUNT * (1 + n_blocks)  # the shuffle's one sha256_many_small call
    phase_kernels(report, card, args.seed, k2_rows)

    print("[calibrate]", json.dumps(dev.use_device_hasher(calibrate=True)), flush=True)
    dev.use_host_hasher()

    bls.bls_active = False
    t0 = time.perf_counter()
    dev.use_device_hasher(calibrate=False)
    genesis = harness.genesis(spec, args.validators, synthetic_pubkeys=True, seed=args.seed)
    states = (genesis, genesis.copy())
    dev.use_host_hasher()
    report["setup_s"] = time.perf_counter() - t0
    print(f"[setup] genesis of {args.validators} validators and a copy in {report['setup_s']:.1f}s", flush=True)

    root_counts = state_root_phase(report, spec, states)
    transition_counts = transition_phase(report, spec, states, args.slots)

    records = []
    for name, replaces in (("sha256_blocks", "consensus_specs_tpu/ops/sha256_pallas.py:45"),
                           ("sha256_raw_blocks", "consensus_specs_tpu/ops/sha256.py:122")):
        launches = root_counts["launches"][name] + transition_counts["launches"][name]
        require(launches > 0, f"{name} was not launched on the main path")
        k = report["kernels"][name]
        records.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
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
    }))
    print(report["env"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
