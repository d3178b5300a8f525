"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0] [--validators 524288] [--slots 2] [--altair-blocks 1]

Phases, each raising on any mismatch:

0. build: nvcc for sm_90a on every source of ops/csrc (sha256.cu, fq.cu,
   fq_pow.cu, curve.cu, fq_inv.cu, flag_deltas.cu, fr_fft.cu, probe.cu), one
   process each, all started together.
1. env: torch/CUDA versions, the card's name and power limit; the liveness
   probe (probe.cu, ``x + 1`` on (8, 128) int32) against its plain version.
2. kernels: K1 (sha256_blocks) and K2 (sha256_raw_blocks) on 2^20 random
   blocks, bit-exact against their plain PyTorch versions on the card and
   against hashlib on a sample, timed by CUDA events and by the profiler's
   device time (three windows), beside a bound from the instructions of
   their SASS per pipe (``sass_pipes``); merkle_reduce / merkle_levels / item_roots
   over 2^20 chunks against loops of the plain version. K3 (fq_mul) and K4
   (fq_addsub, all three op codes) on random canonical field elements and
   edge values at 4,608 and 16,384 elements: the main path's lane-group
   kernels and the one-thread kernels kept for measurement, bit-exact
   against their plain versions and against Python integers on a sample,
   with a stride-0 operand in either position. K5 (fq_pow) and K6
   (fq2_pow), the pow chains, at 1, 260 and 16,385 elements for each of the
   four exponents ((p+1)/4, (p-1)/2, (p-3)/4, p-2) on random values and
   edge values (in Fq every value of the K3/K4 edge pairs, 0 included):
   bit-exact against their plain versions on the card and against Python
   integers on a sample. K9 (fq_inv), the inversion by binary GCD, at 1,
   260 and 16,385 elements on the same Fq values: bit-exact against its
   plain version (Fermat's a^(p-2)) and Python integers. K7
   (g1_mul_static) and K8 (g2_mul_static), the static scalar ladders, at 1, 130, 260 and 16,385
   points for k = |x| and a random k, on random multiples of the
   generators and the edge points (infinity, points outside the
   r-torsion, the G1 3-torsion points): bit-exact against their plain
   version on the card (which launches no kernel) and against the host
   oracle on a sample. Each of K3-K9 is also checked at every size the
   main path's flushes launch it at with the default arguments
   (``FLUSH_SIZES``), in the same plain run; a size a flush launches
   outside those is checked after the flushes.
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
   exponentiation, all on K3-K9). Every row must hold, a sample of rows
   must be decided the same by the host oracle, and the post-state root
   must equal the host's at every slot. Each flush is timed from its call
   to its last result (checks/s); the first is traced under torch.profiler
   for the card's busy share. Each flush must make exactly the K3-K9
   launches of ``FLUSH_LAUNCHES``; the launch-size histogram of the
   first untraced flush is printed. Then a tampered block (one
   attestation signed over another message): the card must reject exactly
   that row, the host oracle must agree, and the transition must raise on
   replay.
6. altair: a mainnet-preset altair chain of ``--validators`` validators with
   the same keys: genesis with both sync committees, then 95 empty slots
   through the epoch engine (use_vectorized_epoch, use_batched_attestations,
   its torch backend: K10 flag_deltas on the card) and the device hasher,
   across epochs 0 -> 1 and 1 -> 2; participation drawn from the seed (~95%
   of validators with each flag); then ``--altair-blocks`` signed blocks
   (1: the boundary block 96 alone; 2 or more: from slot 95), each with
   128 attestations in halves and a sync aggregate with ~1/16 of its 512
   seats off. The host run builds them with the
   numpy engine, the host hasher and the reference BLS; the device run
   applies them with K10, the device hasher and one deferred flush a block
   on the card (two calls: the 128-key bucket and the sync aggregate's
   512-key bucket). Every root must equal the host's, every row hold, a
   sample agree with the host oracle (the sync row of the first block
   included), each call make the launches of ``FLUSH_LAUNCHES`` and
   ``SYNC_CALL_LAUNCHES``; the block at 96 runs epoch 2 -> 3 (K10 three
   times at ``--validators`` rows), timed against the numpy engine's. Then
   the last block again on its pre-state, its sync aggregate signing
   another root: exactly that row fails, and the host oracle agrees.
7. capella: the same chain on capella, post-merge (the genesis state's
   execution payload header that of an empty payload), with 1/256 of the
   registry (2,048 at 2^19, drawn from the seed) on eth1 credentials,
   exited at epoch 2 and withdrawable from it; ``CAPELLA_BLOCKS`` (3)
   signed blocks from slot 95, each as altair's plus an empty execution payload
   carrying the expected withdrawals and 16 BLS-to-execution changes of
   validators still on BLS credentials (147 checks a block: the first call
   146 rows of the 128-key bucket). Epoch 2 -> 3 sweeps the backlog into
   the withdrawals queue (``full_withdrawals``, a stage of the engine) and
   the payloads after it carry 16 withdrawals each; the tampered block has
   one change signed over another root. The altair and capella sync calls
   together must run both ``SYNC_CALL_LAUNCHES`` variants. K10 is then held
   bit-exact against its plain version on altair's epoch columns and
   seeded edge rows, and against Python integers past 2^63, and timed.
8. generators: the vector factory (``generators.gen_runner.run_generator``)
   at capella mainnet on the card: the operations runner's attestation
   handler (20 cases with ``--bls-defer``: one flush on K3-K9, its pubkeys
   decoded anew) and ssz_static (mode_random, count 2: every container,
   BeaconState among them; roots on K1), then the same providers on the
   host oracle (the reference BLS, hashlib). Every file byte-identical and
   the journals' entries equal; no case failed or retried; the
   invalid-signature rows False on the card as on the host and exactly
   those cases replayed; K1 and each of K3-K9 launched. Then phase 10,
   then the K3-K9 checks at any size the phase0, altair, capella and
   generator flushes launched outside ``FLUSH_SIZES``, then phase 9.
9. timing: K3-K9 each at its most frequent size of a flush, in turns in
   one profiler window (the median of three), beside its bound, the launch
   floor (the probe's device time) and its plain version's time. The
   comparisons in turns (K3/K4's one-thread kernels at several sizes,
   K5-K8 against the loops of K3/K4 launches they replaced, K9 against K5
   at p - 2, the latency at 1 element) run in ``kernel_turns.py``, from the
   flush's histogram this script keeps in ``build/smoke_flush.json``.
10. kzg, the R&D forks: the FFT entry points (``fft_torch.fft_device``
   forward and inverse, ``das_fft_extension_device``) at a mainnet DAS blob
   of 16,384 points on K11 fr_fft and K12 fr_mul, equal to crypto/fr.py's;
   K12 (each op, with the edge values 0, 1, r - 1) and K11 (forward and
   inverse at 16,384 and 32,768, at one pass, a short last pass and three
   passes, the das extension at 16,384) bit-exact against their plain
   versions on the card, timed beside their bounds (SASS per pipe, or
   bytes; K11's work counted as the butterflies of its earlier kernel of
   one launch a stage or as its own SASS, whichever is less). Then the
   KZG verifiers on the pairing
   pipeline (``bls_torch.run_checks``), at mainnet's widths on the minimal
   preset's 64-power development setup, fixtures from its public secret:
   the sharding spec's ``verify_degree_proofs`` on 256 body summaries (a
   block's MAX_SHARD_HEADERS_PER_SHARD x INITIAL_ACTIVE_SHARDS), 8 with a
   degree proof for a larger count and 2 off the curve, must name exactly
   those 10; ``verify_kzg_proof_batch`` on 16 blobs x 8 points (8 wrong y,
   2 malformed, one constant blob's infinity proofs) and
   ``check_multi_kzg_proof_batch`` on 32 cosets of 8 (2 tampered) must
   give the exact masks; the das spec's ``sample_data`` -> ``verify_samples``
   on a 16-point blob passes, and names a tampered sample. Each call is
   one pairing call making ``PAIRING_CALL_LAUNCHES``; the host oracle
   decides a valid and a tampered row of each batch the same.

Prints the whole report as one ``[report]`` JSON line, then one JSON line
of kernel records, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Needs a CUDA card: without one it exits
non-zero before printing any result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from consensus_specs_tpu_torch import engine, harness, probe  # noqa: E402
from consensus_specs_tpu_torch.config import preset_for  # noqa: E402
from consensus_specs_tpu_torch.crypto import bls, fr, kzg  # noqa: E402
from consensus_specs_tpu_torch.crypto.bls import ciphersuite  # noqa: E402
from consensus_specs_tpu_torch.engine import delta_checks as dc  # noqa: E402
from consensus_specs_tpu_torch.engine import ops_torch  # noqa: E402
from consensus_specs_tpu_torch.ops import bls_torch, cuda_build, fft_torch, fq, fq_cuda, fq_plain, fr_cuda  # noqa: E402
from consensus_specs_tpu_torch.ops import fr_plain, kzg_torch  # noqa: E402
from consensus_specs_tpu_torch.ops import curve_torch as cj  # noqa: E402
from consensus_specs_tpu_torch.ops import ladder_checks as lc  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256 as dev  # noqa: E402
from consensus_specs_tpu_torch.ops import sha256_cuda, sha256_plain  # noqa: E402
from consensus_specs_tpu_torch.specs import build_spec  # noqa: E402

SOURCE = "consensus_specs_tpu_torch/ops/csrc/sha256.cu"
# the flush's launch-size histogram, kept for kernel_turns.py
FLUSH_RECORD = ROOT / "build" / "smoke_flush.json"
FQ_SOURCE = "consensus_specs_tpu_torch/ops/csrc/fq.cu"
FQ_POW_SOURCE = "consensus_specs_tpu_torch/ops/csrc/fq_pow.cu"
CURVE_SOURCE = "consensus_specs_tpu_torch/ops/csrc/curve.cu"
FQ_INV_SOURCE = "consensus_specs_tpu_torch/ops/csrc/fq_inv.cu"
PROBE_SOURCE = "consensus_specs_tpu_torch/ops/csrc/probe.cu"
# K1/K2's and K9's bounds count the instructions a thread issues, per
# pipe, in the SASS of this run's build (``sass_pipes``): K1 and K2 are
# straight-line code after a bounds check, K9 one loop of K9_ROUNDS rounds
# (fq.cuh kInvRounds). The mangled names of their kernels:
SHA256_SASS = {"sha256_blocks": "sha256_kernelILb1E", "sha256_raw_blocks": "sha256_kernelILb0E"}
K9_SASS, K9_ROUNDS = "fq_inv_kernel", 37
# Hopper's pipes a clock per SM (4 schedulers): each scheduler issues one
# warp instruction a clock (128 thread instructions an SM); the ALU pipe
# (integer adds, logic, shifts, compares, selects, byte permutes) and the
# FMA pipe (IMAD and IMUL in every form, FP32 arithmetic) each take 16
# lanes a scheduler (64 an SM). Other instructions (loads, stores,
# branches, moves, uniform-datapath ones) count against the issue rate
# only. An IMAD.WIDE counts once on the FMA pipe: the least time it takes.
ISSUE_PER_SM_CLOCK, PIPE_PER_SM_CLOCK = 128, 64
SASS_ALU = {"IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX", "IABS", "PLOP3", "FSEL", "FSETP",
            "SGXT", "BMSK"}
SASS_FMA = {"IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "HMUL2", "HADD2"}
# 32-bit integer instructions per field element: the work of the algorithm,
# counted once from the one-thread form in csrc/fq.cuh and kept whatever
# kernel implements it (the lane-group kernels run more instructions in
# all, for their exchanges), so every kernel's roofline reads the same work.
# Repacking an element's limbs in (8 limbs -> 3 words: 10 shift/or each
# group, 40) and out (16 shift/and a group, 64).
PACK_IN_OPS, PACK_OUT_OPS = 40, 64
# K3: the CIOS loop is 12 x 12 operand steps and 12 x 12 reduction steps,
# each a 32 x 32 -> 64-bit multiply (2: low and high halves) and two 64-bit
# adds (4), so 6 a step: 1,728; plus 12 m = t0 * n0' multiplies, the
# conditional subtraction (12 subtract-with-borrow, 12 selects): 1,764; and
# the repacking of two operands in and one result out (144): 1,908.
K3_ARITH_OPS = 2 * 144 * 6 + 12 + 24
K3_INT_OPS = K3_ARITH_OPS + 2 * PACK_IN_OPS + PACK_OUT_OPS
# K4: a 12-word add or subtract with carries (24), the conditional
# subtraction or add-back of p (24 + 12): 60; and the same repacking: 204.
K4_ARITH_OPS = 24 + 36
K4_INT_OPS = K4_ARITH_OPS + 2 * PACK_IN_OPS + PACK_OUT_OPS
FQ_BYTES = 3 * 4 * 32  # two (32,) int32 operands read, one written
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 results per clock
# Launches of one flush of a 128-attestation mainnet block at 2^19
# validators. Before the pow chains had their kernels a flush made 10,047
# K3 and 22,372 K4 launches (32,419). Its 10 chains ran inside them: 6
# Fq chains (2 fq_pow_bits, 4 fq.inv) of 1,217 + 2,440 = 3,657 K3 launches
# (one a bit and one a set bit: 379 + 229 for (p+1)/4, 380 + 229 for
# (p-1)/2, 381 + 229 for p-2), and 4 Fq2 chains of 2,432 K3 and 4,864 K4
# launches (one K3 and two K4 a squaring and a product: 2 x (379 + 228) +
# 2 x (380 + 229) = 2,432). Each chain is now one K5 or K6 launch, so
# K3 10,047 - 3,657 - 2,432 = 3,958, K4 22,372 - 4,864 = 17,508, in all
# 21,466 K3/K4 launches and 10 chain launches. The flush's 5 static scalar
# ladders by |x| (2 on G1 in the pubkey decode's subgroup test, 1 on G2 in
# the signatures', 2 on G2 in hash-to-G2's cofactor clearing) ran inside
# those: 556 K3 and 1,022 K4 launches a G1 ladder, 556 and 2,134 a G2
# ladder. Each ladder is now one K7 or K8 launch, so K3 3,958 - 5 x 556 =
# 1,178, K4 17,508 - (2 x 1,022 + 3 x 2,134) = 9,062: 10,240 K3/K4
# launches and 15 chain and ladder launches. Of the 6 Fq chains, the 4
# inversions (fq.inv: tower.fq2_inv in hash-to-G2, jac_to_affine of the
# hashed points and of the aggregate keys, tower.fq12_inv in the final
# exponentiation) are each one K9 launch now; K5 keeps the Legendre test's
# (p - 1) / 2 and fq_sqrt's (p + 1) / 4.
FLUSH_LAUNCHES = {"fq_mul": 1178, "fq_addsub": 9062, "fq_pow": 2, "fq2_pow": 4, "g1_mul_static": 2,
                  "g2_mul_static": 3, "fq_inv": 4}
DEFAULT_VALIDATORS = 1 << 19
FQ_SIZES = [128 * 2 * 18, 16384]  # K3/K4 checked first: an Fq12 product of 128 Miller loops, a decode
# Every other size the main path's flushes launch K3-K9 at with the default
# arguments (2^19 validators, seed 0: the phase0, altair, capella and
# generator flushes; the report's fq/pow/inv/ladder_checked_sizes of a run
# on the card), so that the first kernel checks cover them with one plain
# run of each of K5-K9; a size a flush launches outside these is checked
# after the flushes (``flush_sizes_unchecked_before`` in the report).
FLUSH_SIZES = {
    "fq": [1, 2, 3, 4, 6, 8, 9, 10, 12, 15, 16, 18, 20, 23, 24, 30, 31, 32, 36, 40, 48, 60, 61, 64, 72, 80, 96, 120,
           121, 130, 144, 146, 239, 241, 242, 260, 288, 292, 390, 421, 438, 520, 584, 780, 876, 1040, 1168, 1170,
           1300, 1314, 1460, 1560, 1752, 2080, 2336, 2340, 2628, 3120, 3504, 4160, 4672, 4680, 5200, 5256, 5840,
           6240, 7008, 8320, 9344, 9360, 10512, 13347, 14316, 14372, 14820, 16385, 18720, 21024],
    "fq_pow": [2, 3, 4, 8, 23, 292, 421, 13347, 14316, 14372, 14820],
    "fq2_pow": [2, 4, 130, 146, 292],
    "fq_inv": [2, 4, 130, 146, 292],
    "g1_mul_static": [3, 8, 23, 421, 13347, 14316, 14372, 14820],
    "g2_mul_static": [2, 146],
}

P = fq.P_INT
RINV = pow(1 << 384, -1, P)
OPS = {  # K4's op code (None: K3) and the value in Python integers
    "mul": (None, lambda x, y: x * y * RINV % P), "add": (0, lambda x, y: (x + y) % P),
    "sub": (1, lambda x, y: (x - y) % P), "neg": (2, lambda x, y: (-y) % P),
}
_EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, (1 << 380) - 1, 1 << 380, (1 << 371) - 1, int("FFF" * 31, 16)]
# every pair of edge values (a - b with a < b among them), sums just below,
# at and just above p, and carries and borrows through every lane of a group
EDGE_PAIRS = [(x, y) for x in _EDGE for y in _EDGE] + [
    (x, (P + d - x) % P) for x in (1, 5, P // 2, (1 << 380) - 1) for d in (-1, 0, 1)]


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

    def bound_ms(self, messages: int, ops_per_message: int, nbytes: int) -> tuple:
        """The bound of ``messages`` of ``ops_per_message`` 32-bit integer
        operations each, all on one pool of 64 a clock per SM, and ``nbytes``
        of device memory traffic."""
        return self.cycles_bound_ms(messages * ops_per_message / INT32_LANES_PER_SM, nbytes)

    def sass_bound_ms(self, messages: int, sass: dict, nbytes: int) -> tuple:
        """The bound of ``messages`` threads, each issuing ``sass``
        (``sass_pipes``), and ``nbytes`` of device memory traffic."""
        return self.cycles_bound_ms(messages * sass["sm_cycles"], nbytes)

    def cycles_bound_ms(self, sm_cycles: float, nbytes: int) -> tuple:
        ops_ms = sm_cycles / (self.sms * self.max_sm_mhz * 1e6) * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def sass_pipes(lib: Path, symbol: str, trips: int = 1, loops: int = 0) -> dict:
    """The instructions one thread of the kernel whose mangled name holds
    ``symbol`` issues, per pipe, from ``cuobjdump -sass`` of ``lib``: the
    instructions of each of its ``loops`` loops (a branch back to an
    earlier address; the function has no other) ``trips`` times, the rest
    once, predicated ones as issued, the padding after the end (NOP, the
    branch to itself) not. ``sm_cycles`` is the least an SM takes for it:
    the largest of the ALU and FMA pipes' counts over 64 and all the
    instructions over 128 (``SASS_ALU``, ``SASS_FMA``)."""
    cuobjdump = Path(cuda_build.nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs = [f for f in re.split(r"^\s*Function : ", text, flags=re.M)[1:] if symbol in f.split("\n", 1)[0]]
    require(len(funcs) == 1, f"{len(funcs)} functions named like {symbol} in the SASS of {lib}")
    code = []
    for a, op, args in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                                  funcs[0]):
        target = re.search(r"0x([0-9a-f]+)", args) if op.split(".")[0] == "BRA" else None
        require(target is not None or op.split(".")[0] != "BRA", f"{symbol}: a branch without an address: {op}{args}")
        code.append((int(a, 16), op, int(target.group(1), 16) if target else None))
    back = [(target, addr) for addr, _, target in code if target is not None and target < addr]
    require(len(back) == loops, f"{symbol}: {len(back)} loops in the SASS, expected {loops}")
    histogram = Counter()
    for addr, op, target in code:
        if op != "NOP" and target != addr:
            histogram[op] += trips if any(lo <= addr <= hi for lo, hi in back) else 1
    alu = sum(n for op, n in histogram.items() if op.split(".")[0] in SASS_ALU)
    fma = sum(n for op, n in histogram.items() if op.split(".")[0] in SASS_FMA)
    issue = sum(histogram.values())
    cycles = {"alu": alu / PIPE_PER_SM_CLOCK, "fma": fma / PIPE_PER_SM_CLOCK, "issue": issue / ISSUE_PER_SM_CLOCK}
    by = max(cycles, key=cycles.get)
    return {"alu": alu, "fma": fma, "issue": issue, "sm_cycles": cycles[by], "bound_by_pipe": by,
            "histogram": dict(histogram.most_common())}


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


def traced(run) -> list:
    """The CUDA kernel events of ``run()``, traced by torch.profiler after
    a warm-up pass of it under the same profiler: CUPTI drops events at the
    start of a trace, sometimes most of a short one, and the warm-up pass
    takes that loss (its events are discarded)."""
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA], schedule=schedule) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms_turns(fns: dict, reps: int = 20, windows: int = 3, tries: int = 9, per_call: dict = None) -> dict:
    """Mean device time of one launch of each kernel in ``fns`` (a
    substring of its symbol -> a call that launches it, ``per_call[k]``
    times where given, else once), the calls made in
    turns in one profiler window: in order on even rounds, reversed on odd
    ones; the median over ``windows`` windows. A small kernel's CUDA-event
    time per call is the host's time to enqueue it; this is the time the
    card spends in it. CUPTI may drop events at a buffer edge, often the
    first launches of a short window: a window that saw fewer than half
    of any kernel's launches is measured again, up to ``tries`` windows
    in all, and then the phase fails. The median, since one window's
    times have been seen off by one factor for all its kernels (1.4x and
    0.83x in two windows running after each other)."""
    order = list(fns)

    def run():
        for r in range(reps):
            for k in order if r % 2 == 0 else order[::-1]:
                fns[k]()

    kept = []
    for window in range(1, tries + 1):
        averages = traced(run)
        events = {k: [e for e in averages if k in e.key] for k in fns}
        counts = {k: sum(e.count for e in ev) for k, ev in events.items()}
        if all(counts[k] >= max(1, reps * (per_call or {}).get(k, 1) // 2) for k in fns):
            kept.append({k: sum(e.self_device_time_total for e in ev) / counts[k] / 1e3 for k, ev in events.items()})
            if len(kept) == windows:
                return {k: statistics.median(w[k] for w in kept) for k in fns}
        else:
            print(f"[profiler] window {window} of {tries} saw {counts} launches of {reps} calls each", flush=True)
    raise AssertionError(f"the profiler saw enough launches in {len(kept)} of {tries} windows, {windows} needed")


def device_ms(fn, kernel: str, reps: int = 20, windows: int = 3, per_call: int = 1) -> float:
    return device_ms_turns({kernel: fn}, reps, windows, per_call={kernel: per_call})[kernel]


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max())


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_build(report: dict) -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    builds = (sha256_cuda.build, fq_cuda.build, fq_cuda.build_pow, fq_cuda.build_curve, fq_cuda.build_inv,
              ops_torch.build, fr_cuda.build, probe.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        libs = list(pool.map(lambda build: build(verbose=True), builds))
    report["build_s"] = time.perf_counter() - t0
    print(f"[build] {SOURCE}, {FQ_SOURCE}, {FQ_POW_SOURCE}, {CURVE_SOURCE}, {FQ_INV_SOURCE}, {FLAG_DELTAS_SOURCE}, "
          f"{FR_SOURCE}, {PROBE_SOURCE} in "
          f"{report['build_s']:.1f}s: "
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


def field_pairs(n: int, rng, edges: bool = True) -> tuple:
    """n operand pairs on the card (random canonical values, with the edge
    pairs as the last rows where n has room for them) and their Python
    integers."""
    tail = EDGE_PAIRS if edges and n >= len(EDGE_PAIRS) else []
    pairs = [(int.from_bytes(rng.bytes(48), "big") % P, int.from_bytes(rng.bytes(48), "big") % P)
             for _ in range(n - len(tail))] + tail
    av, bv = [x for x, _ in pairs], [y for _, y in pairs]
    return torch.from_numpy(fq.to_limbs(av)).cuda(), torch.from_numpy(fq.to_limbs(bv)).cuda(), av, bv


def fq_plain_op(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return fq_plain.mul(a, b) if op == "mul" else fq_plain.addsub(a, b, OPS[op][0])


# each K3/K4 variant: the main path's lane-group kernel and the one-thread
# kernel kept for measurement, with the tag of its kernel symbol in fq.cu
FQ_SYMBOLS = {"main": "lanes", "thread": "thread"}


def fq_variants(op: str) -> dict:
    """K3 (op "mul") or K4 as each kernel computes it: "main" (the main
    path's wrapper) and "thread" (measurement only)."""
    code = OPS[op][0]
    if op == "mul":
        return {"main": fq_cuda.fq_mul, "thread": fq_cuda.fq_mul_thread}
    return {"main": lambda a, b: fq_cuda.fq_addsub(a, b, code),
            "thread": lambda a, b: fq_cuda.fq_addsub_thread(a, b, code)}


def phase_fq_kernels(report: dict, seed: int, sizes: list, label: str) -> None:
    """Every K3/K4 kernel bit-exact against its plain version at each of
    ``sizes`` elements, random values and (where there is room) the edge
    pairs; against Python integers on a sample and every edge row; a
    stride-0 operand in either position. ``report["fq_checks"]`` keeps
    each kernel's largest error over every call."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, *sizes])
    errs = report.setdefault("fq_checks", {})
    for n in sizes:
        a, b, av, bv = field_pairs(n, rng)
        edges = len(EDGE_PAIRS) if n >= len(EDGE_PAIRS) else 0
        sample = list(range(0, n - edges, max(1, (n - edges) // 64))) + list(range(n - edges, n))
        for op, (_, ref) in OPS.items():
            want = fq_plain_op(op, a, b)
            want_ints = [ref(av[i], bv[i]) for i in sample]
            name = "fq_mul" if op == "mul" else "fq_addsub"
            for variant, fn in fq_variants(op).items():
                got = fn(a, b)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                require(err == 0, f"{name} {variant} {op} disagrees with its plain version at {n} (max abs err {err})")
                require(list(fq.from_limbs(got[sample].cpu().numpy())) == want_ints,
                        f"{name} {variant} {op} disagrees with Python integers at {n}")
                for x, y in ((a[:1], b), (a, b[:1])):
                    e = max_abs_err(fn(x, y), fq_plain_op(op, x, y))
                    require(e == 0, f"{name} {variant} {op} with a stride-0 operand disagrees (max abs err {e})")
                key = name if variant == "main" else f"{name}_{variant}"
                errs[key] = max(errs.get(key, 0), err)
    report.setdefault("fq_checked_sizes", []).extend(sizes)
    print(f"[kernels] K3/K4 ({label}): main (lane-group) and one-thread kernels bit-exact at {sizes} elements, "
          f"{len(EDGE_PAIRS)} edge pairs where n has room, ops {list(OPS)}, stride 0 either side: {errs} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


POW_SIZES = [1, 260, 16385]  # one element, a flush's 2 x 130 rows, a decode's 16,385 keys
# K5/K6: the wrapper, the plain version, the JAX function replaced, the
# exponent each is timed with (its main-path callers' longest: the time
# barely depends on which) and the exponents of its turns (K5: both of its
# flush's chains)
POW = {
    "fq_pow": {"degree": 1, "kernel": fq_cuda.fq_pow, "plain": fq_plain.pow_bits, "timed": "legendre",
               "turns": ("legendre", "sqrt"), "replaces": "consensus_specs_tpu/ops/curve_jax.py:282"},
    "fq2_pow": {"degree": 2, "kernel": fq_cuda.fq2_pow, "plain": fq_plain.fq2_pow_bits, "timed": "legendre",
                "turns": ("legendre",), "replaces": "consensus_specs_tpu/ops/curve_jax.py:294"},
}
# Fq values the K5 and K9 checks end on: every value of the K3/K4 edge
# pairs (0 included) and pow's edge values (1, p - 1, R mod p)
FQ_EDGES = list(dict.fromkeys([v for pair in EDGE_PAIRS for v in pair] + fq_plain.POW_EDGES[1]))


def resident_int_ops(products: int, sums: int, elements: int) -> int:
    """The integer operations of a kernel that keeps its values in
    registers from the first field op to the last (K5-K8): each product
    and sum without K3/K4's per-call repacking, and the repacking of its
    ``elements`` Fq elements in and out once."""
    return products * K3_ARITH_OPS + sums * K4_ARITH_OPS + elements * (PACK_IN_OPS + PACK_OUT_OPS)


def chain_work(name: str, e: int) -> tuple:
    """(Montgomery products, field sums, serial, rounds) of one element's
    chain, as fq.cuh computes it. Both walk the 4-bit window (pow,
    fq2_pow): 14 products for the table, then 4 squares for each nibble
    below the top one and a product at each nonzero one, each square or
    product one round (K5: one Fq product; K6: one batch of Fq products).
    The bound counts an Fq2 square as 2 Fq products and 3 sums, an Fq2
    product at Karatsuba's 3 and 5, the least the function needs (the
    kernel takes 4 and 2). serial: the Fq products one after another on the
    bit-serial walk (a square at every bit and a product at every set bit),
    as K5 ran them before this window and K6 before its batches. At (p - 1)
    / 2: K6 1,064 products, 1,648 sums, 1,447 serial, 480 rounds; K5 480
    products and rounds, 609 serial."""
    bits, ones = e.bit_length(), bin(e).count("1")
    nibbles = (bits + 3) // 4
    nonzero = sum(1 for i in range(nibbles - 1) if (e >> 4 * i) & 15)
    squares, products = 4 * (nibbles - 1), 14 + nonzero
    if name == "fq_pow":
        return squares + products, 0, bits + ones, squares + products
    return (2 * squares + 3 * products, 3 * squares + 5 * products, 2 * bits + 3 * ones,
            squares + products)


def pow_operand(n: int, degree: int, rng, edges: bool = True) -> tuple:
    """n elements of Fq (degree 1) or Fq2 on the card, random, with the
    edge values (Fq: ``FQ_EDGES``) as the last rows where n has room; and
    their integers."""
    if degree == 2:
        ints = fq_plain.pow_values(n, degree, rng, edges)
    else:
        tail = FQ_EDGES if edges and n >= 2 * len(FQ_EDGES) else []
        ints = [int.from_bytes(rng.bytes(48), "big") % P for _ in range(n - len(tail))] + tail
    return torch.from_numpy(fq.to_limbs(ints)).cuda(), ints


def edge_rows(n: int, degree: int) -> int:
    """How many of ``pow_operand``'s last rows are edge values."""
    if degree == 2:
        return len(fq_plain.POW_EDGES[2]) if n >= 16 else 0
    return len(FQ_EDGES) if n >= 2 * len(FQ_EDGES) else 0


def phase_pow_kernels(report: dict, seed: int, sizes: dict, label: str) -> None:
    """K5/K6 bit-exact against their plain versions on the card, for each
    of the four exponents, at each of ``sizes[name]`` elements, random and
    edge values; against Python integers on a sample and every edge row.
    The kernel is launched at each size; the plain version, elementwise and
    launch-bound whatever its rows, runs once an exponent on the rows of
    every size together. ``report["fq_checks"]`` keeps each kernel's
    largest error."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 5])
    errs = report.setdefault("fq_checks", {})
    for name, k in POW.items():
        degree, ns = k["degree"], sizes[name]
        if not ns:
            continue
        operands = [pow_operand(n, degree, rng) for n in ns]
        rows = torch.cat([a for a, _ in operands])
        for exp_name, e in fq_plain.EXPONENTS.items():
            bits = fq_plain.bits_msb(e)
            wants = k["plain"](rows, bits).split(ns)
            for n, (a, ints), want in zip(ns, operands, wants):
                got = k["kernel"](a, bits)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                require(err == 0, f"{name} {exp_name} disagrees with its plain version at {n} (max abs err {err})")
                sample = sorted(set(range(0, n, max(1, n // 64))) | set(range(n - edge_rows(n, degree), n)))
                values = fq.from_limbs(got[sample].cpu().numpy())
                values = list(values) if degree == 1 else [tuple(v) for v in values]
                require(values == [fq_plain.pow_int(ints[i], e, degree) for i in sample],
                        f"{name} {exp_name} disagrees with Python integers at {n}")
                errs[name] = max(errs.get(name, 0), err)
    report.setdefault("pow_checked_sizes", []).append(sizes)
    print(f"[kernels] K5/K6 ({label}): bit-exact at {sizes} elements for exponents {list(fq_plain.EXPONENTS)}, "
          f"edge values where n has room, Python integers on a sample: "
          f"{ {k: errs[k] for k in POW} } ({time.perf_counter() - t0:.1f}s)", flush=True)


INV_REPLACES = "consensus_specs_tpu/ops/fq.py:201"
P_MINUS_2_BITS = fq_plain.bits_msb(P - 2)


def phase_inv_kernels(report: dict, seed: int, sizes: list, label: str) -> None:
    """K9 bit-exact against its plain version (Fermat's a^(p-2) on the
    card, once on the rows of every size together, as the K5/K6 checks) at
    each of ``sizes`` elements, on random values with ``FQ_EDGES`` as the
    last rows where n has room, and against Python integers on a sample
    and every edge row. ``report["fq_checks"]`` keeps its largest error."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 11])
    errs = report.setdefault("fq_checks", {})
    if sizes:
        operands = [pow_operand(n, 1, rng) for n in sizes]
        wants = fq_plain.pow_bits(torch.cat([a for a, _ in operands]), P_MINUS_2_BITS).split(sizes)
        for n, (a, ints), want in zip(sizes, operands, wants):
            got = fq_cuda.fq_inv(a)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            require(err == 0, f"fq_inv disagrees with its plain version at {n} (max abs err {err})")
            sample = sorted(set(range(0, n, max(1, n // 64))) | set(range(n - edge_rows(n, 1), n)))
            require(list(fq.from_limbs(got[sample].cpu().numpy())) == [fq_plain.pow_int(ints[i], P - 2, 1)
                                                                       for i in sample],
                    f"fq_inv disagrees with Python integers at {n}")
            errs["fq_inv"] = max(errs.get("fq_inv", 0), err)
    report.setdefault("inv_checked_sizes", []).append(sizes)
    print(f"[kernels] K9 ({label}): bit-exact against Fermat's a^(p-2) at {sizes} elements, {len(FQ_EDGES)} edge "
          f"values where n has room, Python integers on a sample: {errs.get('fq_inv')} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)


# K7/K8: the wrapper, the group, and the adapter of the ladder's K3/K4
# composition (curve_torch)
LADDER = {
    "g1_mul_static": {"g2": False, "kernel": fq_cuda.g1_mul_static, "F": cj.FQ},
    "g2_mul_static": {"g2": True, "kernel": fq_cuda.g2_mul_static, "F": cj.FQ2},
}
LADDER_REPLACES = "consensus_specs_tpu/ops/curve_jax.py:219"
LADDER_SIZES = [1, 130, 260, 16385]  # one point, a flush's 130 and 2 x 130 rows, a decode's 16,385 keys


def ladder_work(g2: bool, k: int) -> tuple:
    """(Fq products, Fq sums, serial, rounds) of one element's ladder by k
    as curve.cuh computes it: the base point prepared once (1 square, 1
    product, 2 sums of the coordinate field; 2 rounds), a doubling 4
    squares, 3 products and 11 sums (3 rounds), an addition 3 squares, 11
    products and 8 sums (5 rounds; its doubling case is taken on no
    subgroup point). In Fq2 a square is 2 Fq products and 3 sums, a product
    Karatsuba's 3 and 5 (the least the function needs; the kernel takes 4
    and 2), a sum 2. For k = |x|: 513 products and 735 sums on G1, 1,271
    and 3,499 on G2, 216 rounds on either. With ``resident_int_ops`` (the
    point's 3 or 6 Fq elements repacked once): 513 x 1,764 + 735 x 60 + 3 x
    104 = 949,344 integer operations a G1 point, 1,271 x 1,764 + 3,499 x 60
    + 6 x 104 = 2,452,608 a G2 point. serial: the Fq products one after
    another as the ladders ran before their level schedules (a doubling 5
    squares and 2 products, an addition 5 and 11 and a doubling: 556 on G1,
    1,303 on G2 for |x|)."""
    doublings, additions = k.bit_length() - 1, bin(k).count("1") - 1
    (sq_p, sq_s), (mul_p, mul_s), add_s = ((2, 3), (3, 5), 2) if g2 else ((1, 0), (1, 0), 1)

    def cost(squares: int, products: int, sums: int) -> tuple:
        return squares * sq_p + products * mul_p, squares * sq_s + products * mul_s + sums * add_s

    (prep_p, prep_s), (dbl_p, dbl_s), (add_p, add_ss) = cost(1, 1, 2), cost(4, 3, 11), cost(3, 11, 8)
    serial = (doublings + additions) * cost(5, 2, 0)[0] + additions * cost(5, 11, 0)[0]
    return (prep_p + doublings * dbl_p + additions * add_p, prep_s + doublings * dbl_s + additions * add_ss,
            serial, 2 + 3 * doublings + 5 * additions)


def phase_ladder_kernels(report: dict, seed: int, sizes: dict, label: str) -> None:
    """K7/K8 bit-exact against the plain version on the card at each of
    ``sizes[name]`` elements, for k = |x| and a random k: random multiples
    of the generator as random Jacobian representatives, with the edge
    points (infinity, a point outside the r-torsion, on G1 the 3-torsion
    points (0, 2) and (0, -2)) as the last rows where n has room. The plain
    version runs once a scalar on the points of every size together (as
    the K5/K6 checks), launches no kernel, and its points of a sample and
    of every edge row equal the host oracle's. ``report["fq_checks"]``
    keeps each kernel's largest error."""
    t0 = time.perf_counter()
    rng = np.random.default_rng([seed, 8])
    k_random = int(rng.integers(1 << 40, 1 << 62)) | 1 << 63
    errs = report.setdefault("fq_checks", {})
    for name, spec in LADDER.items():
        g2, ns = spec["g2"], sizes[name]
        if not ns:
            continue
        operands = [lc.ladder_points(n, g2, rng, "cuda") for n in ns]
        rows = tuple(torch.cat([pt[c] for pt, _ in operands]) for c in range(3))
        for k in (cj.X_PARAM, k_random):
            before = dict(fq_cuda.launches)
            want = cj.scalar_mul_static_plain(spec["F"], rows, k)
            require(fq_cuda.launches == before, f"the plain ladder launched: {before} -> {fq_cuda.launches}")
            wants = list(zip(*(c.split(ns) for c in want)))
            for n, (pt, hosts), want_n in zip(ns, operands, wants):
                got = spec["kernel"](pt, k)
                torch.cuda.synchronize()
                err = max(max_abs_err(x, y) for x, y in zip(got, want_n))
                require(err == 0, f"{name} k={k:#x} disagrees with its plain version at {n} (max abs err {err})")
                edges = len(lc.ladder_edges(g2)) if n >= 16 else 0
                sample = sorted(set(range(0, n, max(1, n // 16))) | set(range(n - edges, n)))
                require(lc.limbs_to_ints(got, g2, sample) == [lc.point_ints(hosts[i].mul(k)) for i in sample],
                        f"{name} k={k:#x} disagrees with the host oracle at {n}")
                errs[name] = max(errs.get(name, 0), err)
    report.setdefault("ladder_checked_sizes", []).append(sizes)
    print(f"[kernels] K7/K8 ({label}): bit-exact against the plain version at {sizes} elements for k = |x| and "
          f"{k_random:#x}, edge points where n has room, host oracle on a sample: "
          f"{ {k: errs.get(k) for k in LADDER} } ({time.perf_counter() - t0:.1f}s)", flush=True)


def once_ms(fn) -> float:
    """One call of ``fn`` on the card, from CUDA events (for the plain
    versions of K5-K9: each call is seconds, and the checks ran it warm)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_timing(report: dict, card: "Card", seed: int, hist: dict) -> None:
    """K3-K9 each at its most frequent size of a flush (``hist``: kernel ->
    elements -> launches), with the one-thread K3/K4 at K3/K4's sizes, all
    in turns in one profiler window (the median of three windows), beside
    each one's bound, the launch floor and its plain version's time.
    Bounds: K3/K4 from the algorithm's operations (``K3_INT_OPS``,
    ``K4_INT_OPS``) or bytes; K5-K8 from ``resident_int_ops`` of the chain's
    or the ladder's products and sums (``chain_work``, ``ladder_work``) or
    bytes; K9 from its SASS per pipe (``sass_pipes``). The comparisons in
    turns (K3/K4's sizes, K5-K8 against the loops of K3/K4 launches they
    replaced, K9 against K5 at p - 2, the latency at 1 element) run in
    ``kernel_turns.py``."""
    rng = np.random.default_rng([seed, 13])
    floor = report["probe"]["ms"]
    top = {k: sorted(hist[k], key=lambda n: (-hist[k][n], n))[0] for k in fq_cuda.KERNELS}
    calls, rec = {}, {}  # profiler symbol -> call; record key -> record
    for name, op, ops in (("fq_mul", "mul", K3_INT_OPS), ("fq_addsub", "sub", K4_INT_OPS)):
        n = top[name]
        a, b, _, _ = field_pairs(n, rng, edges=False)
        bound, bound_by = card.bound_ms(n, ops, FQ_BYTES * n)
        plain_ms = cuda_ms(lambda: fq_plain_op(op, a, b), reps=5)
        for variant, fn in fq_variants(op).items():
            calls[f"{name}_{FQ_SYMBOLS[variant]}_kernel"] = lambda fn=fn, a=a, b=b: fn(a, b)
            rec[name if variant == "main" else f"{name}_{variant}"] = {
                "symbol": f"{name}_{FQ_SYMBOLS[variant]}_kernel", "elements": n, "measurement_only": variant != "main",
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by}
    for name, k in POW.items():
        n, e = top[name], fq_plain.EXPONENTS[k["timed"]]
        bits = fq_plain.bits_msb(e)
        a, _ = pow_operand(n, k["degree"], rng, edges=False)
        products, sums, _, _ = chain_work(name, e)
        bound, bound_by = card.bound_ms(n, resident_int_ops(products, sums, k["degree"]), 2 * 128 * k["degree"] * n)
        calls[f"{name}_kernel"] = lambda k=k, a=a, bits=bits: k["kernel"](a, bits)
        rec[name] = {"symbol": f"{name}_kernel", "elements": n, "exponent": k["timed"], "bound_ms": bound,
                     "bound_by": bound_by, "plain_ms": once_ms(lambda: k["plain"](a, bits))}
    n = top["fq_inv"]
    a, _ = pow_operand(n, 1, rng, edges=False)
    sass = sass_pipes(fq_cuda.build_inv(), K9_SASS, trips=K9_ROUNDS, loops=1)
    bound, bound_by = card.sass_bound_ms(n, sass, 2 * 128 * n)
    calls["fq_inv_kernel"] = lambda a=a: fq_cuda.fq_inv(a)
    rec["fq_inv"] = {"symbol": "fq_inv_kernel", "elements": n, "bound_ms": bound, "bound_by": bound_by, "sass": sass,
                     "plain_ms": once_ms(lambda: fq_plain.pow_bits(a, P_MINUS_2_BITS))}
    for name, spec in LADDER.items():
        n, g2 = top[name], spec["g2"]
        pt, _ = lc.ladder_points(n, g2, rng, "cuda", distinct=8)
        products, sums, _, _ = ladder_work(g2, cj.X_PARAM)
        bound, bound_by = card.bound_ms(n, resident_int_ops(products, sums, 3 * (1 + g2)), 6 * 128 * (1 + g2) * n)
        calls[f"{name}_kernel"] = lambda spec=spec, pt=pt: spec["kernel"](pt, cj.X_PARAM)
        rec[name] = {"symbol": f"{name}_kernel", "elements": n, "bound_ms": bound, "bound_by": bound_by,
                     "plain_ms": once_ms(lambda: cj.scalar_mul_static_plain(spec["F"], pt, cj.X_PARAM))}
    ms = device_ms_turns(calls, reps=6)
    for key, r in rec.items():
        r.update(ms=ms[r.pop("symbol")], library_ms=None, floor_ms=floor, flush_launches=hist[key.split("_thread")[0]]
                 .get(r["elements"], 0))
        print(f"[timing] {key} at {r['elements']} elements ({r['flush_launches']} launches a flush): "
              f"{r['ms'] * 1e3:.1f} us on the card; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}), launch floor "
              f"{floor * 1e3:.3f} us; plain {r['plain_ms']:.3f} ms", flush=True)
    report["timing"] = rec


# K1/K2's kernel symbols (sha256.cu's template, with and without the
# padding block), as the profiler names them
SHA256_SYMBOLS = {"sha256_blocks": "sha256_kernel<true>", "sha256_raw_blocks": "sha256_kernel<false>"}


def phase_kernels(report: dict, card: Card, seed: int, k2_rows: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 << 20
    blocks = torch.randint(-(2**31), 2**31, (n, 16), dtype=torch.int32, device="cuda", generator=g)
    sample = blocks[:4096].cpu().numpy().tobytes()
    out = {}
    sass = {name: sass_pipes(sha256_cuda.build(), symbol) for name, symbol in SHA256_SASS.items()}
    for name, rows in (("sha256_blocks", n), ("sha256_raw_blocks", k2_rows)):
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
        event_ms = cuda_ms(lambda: kern(x))
        # the device time of a launch from the profiler, in three windows
        # (each after a discarded warm-up step), as the other kernels are timed
        windows = [device_ms(lambda: kern(x), SHA256_SYMBOLS[name], reps=100, windows=1) for _ in range(3)]
        ms = sum(windows) / len(windows)
        plain_ms = cuda_ms(lambda: plain(x), reps=3)
        bound, bound_by = card.sass_bound_ms(rows, sass[name], 96 * rows)
        out[name] = {
            "rows": rows, "max_abs_err": err, "ms": ms, "device_ms_windows": windows, "event_ms": event_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "gb_per_s": 64 * rows / ms / 1e6, "sass": sass[name],
        }
        print(f"[kernels] {name}: {rows} rows {ms:.4f} ms on the card (profiler windows "
              f"{[round(w, 4) for w in windows]}; CUDA events {event_ms:.4f} ms a call), "
              f"{64 * rows / ms / 1e6:.1f} GB/s of input, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{bound / ms:.1%} of it; SASS a message {sass[name]['alu']} ALU, {sass[name]['fma']} FMA, "
              f"{sass[name]['issue']} issued, bound by {sass[name]['bound_by_pipe']}: {sass[name]['histogram']})",
              flush=True)
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
    bound, bound_by = card.sass_bound_ms(n - 1, sass["sha256_blocks"], 32 * n + 32)
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


def bls_phase(report: dict, spec, states: tuple, slots: int, flush_launches) -> tuple:
    """Signed blocks of 128 aggregates, one deferred flush each on the card.
    The first block's flush is traced; checks/s is read from the others.
    Each flush must make ``flush_launches`` (kernel -> launches; None: not
    checked). Returns the main path's counts and the launch-size histogram
    of the first untraced flush (kernel -> elements -> launches)."""
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
        before_sizes = {k: dict(fq_cuda.sizes[k]) for k in fq_cuda.KERNELS}
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
            "sizes": {k: {n: c - before_sizes[k].get(n, 0) for n, c in fq_cuda.sizes[k].items()
                          if c != before_sizes[k].get(n, 0)} for k in fq_cuda.KERNELS},
            "oracle_rows": len(sampled), "oracle_s": oracle_s,
        }
        require(flush_launches is None or rec["launches"] == flush_launches,
                f"slot {rec['slot']}: the flush made {rec['launches']} launches, not {flush_launches}")
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
              f"{ {k: round(v, 3) for k, v in rec['stage_s'].items()} }, K3-K9 launches {rec['launches']}, "
              f"{rec['pubkeys_decoded']} pubkeys decoded, oracle agrees on {len(sampled)} rows", flush=True)
    counts = dev.counters()
    launches = {k: sum(r["launches"][k] for r in per_block) for k in fq_cuda.KERNELS}
    timed = [r for r in per_block if not r["traced"]] or per_block
    hist = timed[0]["sizes"]
    for k in fq_cuda.KERNELS:
        ranked = sorted(hist[k].items(), key=lambda kv: (-kv[1], kv[0]))
        print(f"[bls] slot {timed[0]['slot']} flush, {k} launches by elements (elements: launches, most "
              f"frequent first; {sum(hist[k].values())} launches, {len(ranked)} sizes): {dict(ranked)}", flush=True)
    report["bls"] = {
        "slots": slots, "attestations": n_att, "host_build_s": host_times, "blocks": per_block,
        "launches": launches, "sha256_counts": counts, "flush_sizes": hist,
        "flush_device_idle_share": per_block[0]["profiled"]["device_idle_share"],
        "checks_per_s": sum(r["checks"] for r in timed) / sum(r["flush_s"] for r in timed),
    }
    print(f"[bls] {slots} signed blocks of {n_att[0]} attestations verified on the card; "
          f"{report['bls']['checks_per_s']:.2f} checks/s over the untraced flushes; K3-K9 launches {launches}; "
          f"card idle {report['bls']['flush_device_idle_share']:.4%} of the traced flush", flush=True)
    return {"launches": {**counts["launches"], **launches}}, hist


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


# The altair and capella chains: empty slots from genesis cross the epoch
# boundaries 0 -> 1 and 1 -> 2 through the engine; the signed blocks then
# carry attestations and a sync aggregate (capella: and an execution
# payload and BLS-to-execution changes), and the one at the boundary slot
# 96 runs epoch 2 -> 3, where justification and rewards both run (K10
# three times, one launch a flag) and, on capella, the full-withdrawals
# sweep. One block is the boundary block alone (altair's, after 95 empty
# slots); two or more start at 95 (capella's 95, 96 and 97, after 94).
BOUNDARY_SLOT = 3 * 32


def chain_advance_slot(n_blocks: int) -> int:
    """The last empty slot before a chain's first signed block."""
    return BOUNDARY_SLOT - min(n_blocks, 2)
# capella's blocks: 95, the boundary block 96 (its epoch processing sweeps
# the backlog, its payload pays the first 16 withdrawals) and 97 (the next 16)
CAPELLA_BLOCKS = 3
# capella: 1/256 of the registry (2,048 of 2^19) is a withdrawal backlog,
# exited at epoch 2 and withdrawable from it, so the sweep at 2 -> 3 takes
# it; the chain is post-merge, as mainnet's was at capella
WITHDRAWING_SHARE = 256
WITHDRAWAL_EPOCH = 2
FLAG_DELTAS_SOURCE = "consensus_specs_tpu_torch/ops/csrc/flag_deltas.cu"
FLAG_DELTAS_REPLACES = "consensus_specs_tpu/engine/ops_jax.py:29"
K10_ROW_BYTES = 8 + 1 + 1 + 8 + 8  # increments, two masks in; rewards, penalties out
# An altair block's flush makes two backend calls: its 128 attestations
# and 2 Verify rows in the 128-key bucket (the launches of FLUSH_LAUNCHES)
# and its sync aggregate alone in the 512-key bucket, whose launches
# depend only on the tree sum's depth (9 levels from 257 to 512 keys) and
# on whether the call decodes a key the pubkey cache has not seen: the
# sync committee's keys are decoded by the first flush that meets them.
# Counted on the CPU by wrapping the plain dispatch points (fq_plain's mul,
# addsub, pow_bits, fq2_pow_bits and curve_torch.scalar_mul_static_plain),
# which the counts do not depend on, on one row of 300 and of 480 keys.
# A capella block's 16 BLS-to-execution changes are 16 more Verify rows in
# the first call (146 rows): its launches depend on the key count and on
# whether it decodes, not on its rows, so FLUSH_LAUNCHES holds for it too
# (counted the same way on a 128-key row beside 1 and 2 one-key rows).
SYNC_CALL_LAUNCHES = {
    "decode": {"fq_mul": 1224, "fq_addsub": 9118, "fq_pow": 2, "fq2_pow": 4, "g1_mul_static": 2,
               "g2_mul_static": 3, "fq_inv": 4},
    "cached": {"fq_mul": 1196, "fq_addsub": 9087, "fq_pow": 1, "fq2_pow": 4, "g1_mul_static": 0,
               "g2_mul_static": 3, "fq_inv": 4},
}


class CallRecorder:
    """Wraps the torch backend's batch pipeline for the duration: each
    call's rows, largest key count, keys decoded and K3-K9 launches."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self.real = bls_torch.fast_aggregate_verify_batch_cold

        def call(pubkey_lists, messages, signatures):
            before, decoded = dict(fq_cuda.launches), bls_torch._pubkeys().decoded
            out = self.real(pubkey_lists, messages, signatures)
            self.calls.append({"rows": len(signatures), "keys": max(len(p) for p in pubkey_lists),
                               "decoded": bls_torch._pubkeys().decoded - decoded,
                               "launches": {k: fq_cuda.launches[k] - before[k] for k in fq_cuda.KERNELS}})
            return out

        bls_torch.fast_aggregate_verify_batch_cold = call
        return self

    def __exit__(self, *exc):
        bls_torch.fast_aggregate_verify_batch_cold = self.real


class Timed:
    """Wraps ``spec.<name>`` for the duration, summing its seconds."""

    def __init__(self, spec, *names):
        self.spec, self.names, self.seconds = spec, names, dict.fromkeys(names, 0.0)

    def __enter__(self):
        self.real = {n: getattr(self.spec, n) for n in self.names}
        for n, fn in self.real.items():
            def timed(state, n=n, fn=fn):
                t0 = time.perf_counter()
                fn(state)
                torch.cuda.synchronize()
                self.seconds[n] += time.perf_counter() - t0
            setattr(self.spec, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.spec, n, fn)


def chain_phase(report: dict, fork: str, seed: int, validators: int, n_blocks: int) -> tuple:
    """The altair or capella chain at ``validators`` validators with real
    keys: genesis (both sync committees; capella: post-merge, with the
    withdrawal backlog ``harness.draw_withdrawing`` draws from the seed),
    empty slots through the engine on the torch backend (K10) and the
    device hasher, participation drawn from the seed, then ``n_blocks``
    signed blocks (``chain_advance_slot``: the boundary block 96 alone, or
    95, 96, ...; 128 attestations in halves and a
    sync aggregate of ~1/16 seats off; capella: an empty execution payload
    with the expected withdrawals and 16 BLS-to-execution changes), and the
    last of them again with its sync aggregate (capella: one change) over
    another root. The host run builds them with the numpy engine, the host
    hasher and the reference BLS (checks off while building); the device
    run applies them with K10, the device hasher and one deferred flush a
    block on the card, and must reach the host's post-state root at every
    block. Returns the main path's counts (K1-K10), the flushes' size
    histogram, K10's calls (their columns) and each block's sync-call
    variant."""
    spec = build_spec(fork, "mainnet")
    capella = fork == "capella"
    advance_slot = chain_advance_slot(n_blocks)
    engine.use_vectorized_epoch()
    engine.use_batched_attestations()
    engine.use_backend("torch")
    bls.bls_active = False
    dev.use_device_hasher(calibrate=False)
    t0 = time.perf_counter()
    state = harness.genesis(spec, validators, post_merge=capella)
    withdrawing = harness.draw_withdrawing(spec, state, seed, validators // WITHDRAWING_SHARE, WITHDRAWAL_EPOCH) \
        if capella else []
    genesis_s = time.perf_counter() - t0
    require(len(set(state.current_sync_committee.pubkeys)) > 500, "a degenerate sync committee")
    ops_torch.reset_counters()
    with Timed(spec, "process_epoch") as epochs:
        t0 = time.perf_counter()
        spec.process_slots(state, advance_slot)
        torch.cuda.synchronize()
        advance_s = time.perf_counter() - t0
    advance_k10 = dict(ops_torch.sizes["flag_deltas"])
    require(sum(advance_k10.values()) == 3, f"the advance launched K10 {advance_k10}, not 3 times at epoch 1 -> 2")
    require(not capella or len(state.withdrawals_queue) == 0, "the backlog was swept before epoch 2 -> 3")
    harness.draw_participation(spec, state, seed)
    host_state = state.copy()
    print(f"[{fork}] genesis of {validators} validators{f' ({len(withdrawing)} withdrawing)' if capella else ''} "
          f"{genesis_s:.1f}s; {advance_slot} empty slots {advance_s:.1f}s (epoch processing "
          f"{epochs.seconds['process_epoch']:.1f}s, K10 {advance_k10})", flush=True)

    # the host run: numpy engine, host hasher, reference BLS; builds the blocks
    engine.use_backend("numpy")
    dev.use_host_hasher()
    bls.use_reference()
    blocks, host_roots, host_times = [], [], []
    stage_names = ["process_epoch"] + [n for n in engine.STAGE_NAMES if hasattr(spec, n)]
    with Timed(spec, *stage_names) as host_epoch:
        for _ in range(n_blocks):
            t0 = time.perf_counter()
            blocks.append(harness.next_block(spec, host_state, split=True, sign=True, seed=seed))
            host_times.append(time.perf_counter() - t0)
            host_roots.append(spec.hash_tree_root(host_state))
    if capella:
        change = (37 * seed + 5) % len(blocks[-1].message.body.bls_to_execution_changes)
        tampered = harness.tampered_change_copy(spec, host_state, blocks[-1], change)
        bad_signature = bytes(tampered.message.body.bls_to_execution_changes[change].signature)
    else:
        tampered = harness.tampered_sync_copy(spec, host_state, blocks[-1], seed)
        bad_signature = bytes(tampered.message.body.sync_aggregate.sync_committee_signature)
    require(host_epoch.seconds["process_epoch"] > 0, "the blocks cross no epoch boundary")
    n_att = [len(b.message.body.attestations) for b in blocks]
    full = min(spec.MAX_ATTESTATIONS, 2 * int(spec.get_committee_count_per_slot(host_state, 0)))
    require(all(n == full for n in n_att), f"blocks carry {n_att} attestations, not {full} each")

    # the device run: K10, the device hasher, one deferred flush a block on the card
    engine.use_backend("torch")
    dev.use_device_hasher(calibrate=False)
    bls.use_backend("torch")
    bls.bls_active = True
    spec._shuffle_cache.clear()
    spec._active_indices_cache.clear()
    dev.reset_counters()
    fq_cuda.reset_counters()
    ops_torch.reset_counters()
    k10_calls = []
    real_k10 = ops_torch.flag_deltas

    def recorded(*args, **kwargs):
        k10_calls.append(args)
        return real_k10(*args, **kwargs)

    ops_torch.flag_deltas = recorded
    expect = validators == DEFAULT_VALIDATORS
    per_block, hist = [], {k: {} for k in fq_cuda.KERNELS}
    try:
        with Timed(spec, *stage_names) as dev_epoch:
            for i, (sb, want) in enumerate(zip(blocks, host_roots)):
                if i == len(blocks) - 1:
                    last_pre = state.copy()  # the tampered copy of this block goes there
                body = sb.message.body
                queued = len(state.withdrawals_queue) if capella else 0
                before_sizes = {k: dict(fq_cuda.sizes[k]) for k in fq_cuda.KERNELS}
                t0 = time.perf_counter()
                with CallRecorder() as rec:
                    verifier = harness.apply_block_deferred(spec, state, sb, verifier=TimedVerifier())
                torch.cuda.synchronize()
                block_s = time.perf_counter() - t0
                got = spec.hash_tree_root(state)
                require(got == want, f"{fork} slot {int(state.slot)}: device root {got.hex()} host {want.hex()}")
                bits = list(body.sync_aggregate.sync_committee_bits)
                sync_rows = [j for j, k in enumerate(verifier.entries) if k[0] == "fav" and len(k[1]) == sum(bits)]
                require(len(sync_rows) == 1 and 256 < sum(bits) <= 512, f"sync rows {sync_rows}, {sum(bits)} bits")
                fav = [j for j, k in enumerate(verifier.entries) if k[0] == "fav" and j not in sync_rows]
                v = [j for j, k in enumerate(verifier.entries) if k[0] == "v"]
                changes = len(body.bls_to_execution_changes) if capella else 0
                require(len(v) == 2 + changes, f"{len(v)} Verify rows, not the proposer's, the randao's and "
                        f"{changes} changes")
                # the proposer's, the randao's, the first and last attestation, the last change
                sampled = v[:2] + fav[:1] + fav[-1:] + v[2:][-1:] + (sync_rows if i == 0 else [])
                t1 = time.perf_counter()
                for j in sampled:
                    require(_oracle(verifier.entries[j]) == verifier.results[j],
                            f"{fork} slot {int(state.slot)}: host oracle disagrees on row {j}")
                oracle_s = time.perf_counter() - t1
                launches = {k: sum(c["launches"][k] for c in rec.calls) for k in fq_cuda.KERNELS}
                variant = "decode" if rec.calls[-1]["decoded"] else "cached"  # the sync row is the last bucket
                if expect:
                    require([(c["rows"], c["keys"]) for c in rec.calls] == [(len(v) + len(fav), 128), (1, sum(bits))],
                            f"the flush's calls took {[(c['rows'], c['keys']) for c in rec.calls]} rows and keys, not "
                            f"[({len(v) + len(fav)}, 128), (1, {sum(bits)})]")
                    require(rec.calls[0]["launches"] == FLUSH_LAUNCHES and
                            rec.calls[1]["launches"] == SYNC_CALL_LAUNCHES[variant],
                            f"{fork} slot {int(state.slot)}: the flush's calls made "
                            f"{[c['launches'] for c in rec.calls]} launches, not {FLUSH_LAUNCHES} and "
                            f"{SYNC_CALL_LAUNCHES[variant]} ({variant})")
                for k in fq_cuda.KERNELS:
                    for n, c in fq_cuda.sizes[k].items():
                        if c != before_sizes[k].get(n, 0):
                            hist[k][n] = hist[k].get(n, 0) + c - before_sizes[k].get(n, 0)
                rec_ = {"slot": int(state.slot), "checks": len(set(verifier.entries)), "rows_true": sum(verifier.results),
                        "sync_keys": sum(bits), "block_s": block_s, "flush_s": verifier.flush_s, "calls": rec.calls,
                        "sync_call": variant, "launches": launches, "oracle_rows": len(sampled), "oracle_s": oracle_s}
                extra = ""
                if capella:
                    paid = len(body.execution_payload.withdrawals)
                    rec_.update(changes=changes, withdrawals=paid, queue=len(state.withdrawals_queue),
                                swept=len(state.withdrawals_queue) + paid - queued)
                    extra = (f", {changes} BLS changes, {paid} withdrawals paid, {rec_['swept']} swept, queue "
                             f"{rec_['queue']}")
                per_block.append(rec_)
                print(f"[{fork}] slot {rec_['slot']}: {rec_['checks']} checks all true ({sum(bits)}-key sync "
                      f"aggregate{extra}), block {block_s:.3f}s, flush {verifier.flush_s:.3f}s in "
                      f"{len(rec.calls)} calls of {[c['rows'] for c in rec.calls]} rows and "
                      f"{[c['keys'] for c in rec.calls]} keys, sync call {variant}, K3-K9 launches {launches}, "
                      f"root = host's, oracle agrees on {len(sampled)} rows ({oracle_s:.1f}s)", flush=True)
    finally:
        ops_torch.flag_deltas = real_k10
    k10 = dict(ops_torch.sizes["flag_deltas"])
    require(k10 == {validators: 3}, f"the blocks launched K10 {k10}, not 3 times at {validators} rows")
    require(len(k10_calls) == 3, f"{len(k10_calls)} flag_deltas calls, not 3")
    sha_launches = dev.counters()["launches"]
    if capella:
        swept, paid = [r["swept"] for r in per_block], [r["withdrawals"] for r in per_block]
        boundary = next(i for i, sb in enumerate(blocks) if int(sb.message.slot) % spec.SLOTS_PER_EPOCH == 0)
        require(swept == [len(withdrawing) if i == boundary else 0 for i in range(len(blocks))],
                f"the sweeps took {swept} validators, not the {len(withdrawing)} withdrawing at epoch 2 -> 3")
        require(all(state.validators[i].fully_withdrawn_epoch == WITHDRAWAL_EPOCH for i in withdrawing),
                "a withdrawing validator was not fully withdrawn")
        if expect:
            require(paid == [spec.MAX_WITHDRAWALS_PER_PAYLOAD if i >= boundary else 0 for i in range(len(blocks))],
                    f"the payloads carried {paid} withdrawals")
            require(all(r["checks"] == full + 3 + spec.MAX_BLS_TO_EXECUTION_CHANGES for r in per_block),
                    f"checks a block {[r['checks'] for r in per_block]}")

    # the last block once more, its sync aggregate (capella: one change) signing another root
    verifier = bls.DeferredVerifier()
    try:
        harness.apply_block_deferred(spec, last_pre.copy(), tampered, pre_state=last_pre, verifier=verifier)
    except AssertionError as e:
        require("replayed transition accepted" not in str(e), str(e))
    else:
        raise AssertionError(f"the tampered {fork} block was accepted")
    what = "BLS-to-execution change" if capella else "sync aggregate"
    false_rows = [j for j, r in enumerate(verifier.results) if not r]
    require(len(false_rows) == 1, f"{len(false_rows)} rows rejected, not exactly the tampered {what}")
    key = verifier.entries[false_rows[0]]
    require(key[0] == ("v" if capella else "fav") and key[3] == bad_signature, f"the rejected row is not the tampered {what}")
    require(_oracle(key) is False, f"the host oracle accepts the tampered {what}")
    bls.use_reference()
    dev.use_host_hasher()
    engine.use_backend("numpy")
    engine.use_interpreted_epoch()
    engine.use_direct_attestations()

    timed = per_block[1:] or per_block
    report[fork] = {
        "validators": validators, "genesis_s": genesis_s, "advance_s": advance_s,
        "advance_epoch_s": epochs.seconds["process_epoch"], "advance_k10": advance_k10,
        "host_block_s": host_times, "attestations": n_att, "blocks": per_block,
        "boundary": {"device_epoch_s": dev_epoch.seconds["process_epoch"],
                     "device_rewards_s": dev_epoch.seconds["process_rewards_and_penalties"],
                     "host_epoch_s": host_epoch.seconds["process_epoch"],
                     "host_rewards_s": host_epoch.seconds["process_rewards_and_penalties"],
                     "device_stage_s": dev_epoch.seconds, "host_stage_s": host_epoch.seconds},
        "flush_sizes": hist, "k10_launches": k10, "sha256_launches": sha_launches,
        "checks_per_s": sum(r["checks"] for r in timed) / sum(r["flush_s"] for r in timed),
        "tampered_rejected": false_rows, "withdrawing": len(withdrawing),
    }
    b = report[fork]["boundary"]
    print(f"[{fork}] epoch 2 -> 3 by stage, seconds on the card (K10, device hasher) / numpy engine (host hasher): "
          f"{ {n.replace('process_', ''): (round(dev_epoch.seconds[n], 3), round(host_epoch.seconds[n], 3)) for n in stage_names} }",
          flush=True)
    print(f"[{fork}] {n_blocks} signed blocks from slot {advance_slot + 1}, every root the host's; epoch 2 -> 3 "
          f"on the card {b['device_epoch_s']:.2f}s (rewards {b['device_rewards_s']:.2f}s, K10 {k10}) against the numpy "
          f"engine's {b['host_epoch_s']:.2f}s (rewards {b['host_rewards_s']:.2f}s); "
          f"{report[fork]['checks_per_s']:.2f} checks/s; K1/K2 launches {sha_launches}; the tampered {what} alone "
          f"rejected, the host oracle agrees", flush=True)
    launches = {k: sum(r["launches"][k] for r in per_block) for k in fq_cuda.KERNELS}
    counts = {"launches": {**launches, **sha_launches, "flag_deltas": sum(k10.values())}}
    return counts, hist, k10_calls, [r["sync_call"] for r in per_block]


def phase_flag_deltas(report: dict, card: "Card", seed: int, epoch_calls: list) -> None:
    """K10 bit-exact against its plain version on the card on the epoch's
    own columns (the three calls of the boundary) and on seeded edge rows
    (increments 0 and 32 under every mask pair, upi 0, leak and penalize
    each way); against Python integers on a sample and on rows whose
    numerator lies between 2^63 and 2^64 - 1, past the plain version's
    range. Timed on the epoch's largest-weight flag: the profiler's device
    time a launch (median of three windows), the plain version on the
    card, and one ``flag_deltas`` call's wall time with its copies to the
    card and back; beside the bound: bytes (26 a row) against operations
    (three 64-bit products and a 64-bit division where the row's masks ask
    for one, each counted as one 32-bit operation: a lower bound)."""
    def tensors(cols):
        return (torch.from_numpy(np.ascontiguousarray(cols[0]).view(np.int64)).cuda(),
                torch.from_numpy(np.ascontiguousarray(cols[1])).cuda(),
                torch.from_numpy(np.ascontiguousarray(cols[2])).cuda())

    err = 0
    cases = [(args[:3], args[3:8], args[8], args[9]) for args in epoch_calls]
    n = len(epoch_calls[0][0])
    cases += [(dc.columns(n, seed + j), scalars, leak, penalize) for j, scalars in enumerate(dc.SCALARS)
              for leak in (False, True) for penalize in (False, True)]
    for cols, scalars, leak, penalize in cases:
        t = tensors(cols)
        got = ops_torch.flag_deltas_cuda(*t, *scalars, leak, penalize)
        want = ops_torch.flag_deltas_plain(*t, *scalars, leak, penalize)
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b) for a, b in zip(got, want))
        require(e == 0, f"flag_deltas disagrees with its plain version (max abs err {e})")
        sample = slice(0, 256)
        ints = dc.python_deltas(*(c[sample] for c in cols), *scalars, leak, penalize)
        require([g[sample].cpu().numpy().view(np.uint64).tolist() for g in got] == list(ints),
                "flag_deltas disagrees with Python integers")
        err = max(err, e)
    for leak in (False, True):
        for penalize in (False, True):
            cols = dc.columns(4099, seed + 7)
            got = ops_torch.flag_deltas_cuda(*tensors(cols), *dc.SCALARS_PAST_INT64, leak, penalize)
            require([g.cpu().numpy().view(np.uint64).tolist() for g in got] ==
                    list(dc.python_deltas(*cols, *dc.SCALARS_PAST_INT64, leak, penalize)),
                    "flag_deltas disagrees with Python integers past 2^63")
    # timed on the target flag's call (the largest weight), as the epoch gave it
    args = max(epoch_calls, key=lambda a: a[4])
    t = tensors(args[:3])
    scalars, leak, penalize = args[3:8], args[8], args[9]
    ms = device_ms(lambda: ops_torch.flag_deltas_cuda(*t, *scalars, leak, penalize), "flag_deltas_kernel")
    plain_ms = cuda_ms(lambda: ops_torch.flag_deltas_plain(*t, *scalars, leak, penalize))
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ops_torch.flag_deltas(*args)
        walls.append(time.perf_counter() - t0)
    call_ms = statistics.median(walls) * 1e3
    in_mask, eligible = args[1], args[2]
    divisions = int((in_mask & eligible).sum()) * (not leak) + int((~in_mask & eligible).sum()) * penalize
    ops = 3 * n + divisions
    bound, bound_by = card.bound_ms(ops, 1, K10_ROW_BYTES * n)
    report["flag_deltas"] = {
        "rows": n, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "cases": len(cases) + 4,
    }
    print(f"[flag_deltas] K10 bit-exact against its plain version on the epoch's 3 calls and {len(cases) - 3} seeded "
          f"cases at {n} rows, and against Python integers past 2^63; {ms * 1e3:.2f} us a launch on the card at {n} "
          f"rows, bound {bound * 1e3:.2f} us ({bound_by}, {bound / ms:.1%} of it), plain {plain_ms * 1e3:.1f} us, "
          f"one flag_deltas call with its copies {call_ms:.3f} ms wall", flush=True)


GEN_FORK, GEN_PRESET = "capella", "mainnet"
GEN_SSZ_SEED = 8  # the ssz_static runner's seed of its mainnet mode_random setting
GEN_SSZ_COUNT = 2
GEN_CASES = "consensus_specs_tpu_torch.cases.operations_attestation"


def gen_tree(root: Path) -> dict:
    """Every file the generator wrote under ``root`` (its journal included)."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def generators_phase(report: dict) -> tuple:
    """The vector factory on the card: the operations runner's attestation
    handler (20 cases, ``--bls-defer``: one flush on K3-K9) and ssz_static
    (mode_random, count 2: every container, BeaconState among them) at
    capella mainnet, through ``run_generator`` with the torch BLS backend
    and the device hasher on the card (K1, and K2 where the shuffle's small
    hashes reach it), into one directory; then the same providers on the
    host oracle (the reference BLS, hashlib) into another. Every file must
    be byte-identical and the journals' entries equal; no case may fail or
    be retried (the supervisor's event record); the invalid-signature
    cases' rows must be False on the card, as on the host, and exactly those
    cases replayed; K1 and each of K3-K9 must launch in the card run. A
    generator run starts with no decoded pubkeys, so its flush decodes its
    keys (K7). Returns the card run's launches and its K3-K9 launch sizes."""
    import shutil

    from consensus_specs_tpu_torch.debug.random_value import RandomizationMode
    from consensus_specs_tpu_torch.generators import gen_from_tests
    from consensus_specs_tpu_torch.generators.gen_runner import run_generator
    from consensus_specs_tpu_torch.generators.runners import ssz_static
    from consensus_specs_tpu_torch.resilience import CaseJournal, events
    from consensus_specs_tpu_torch.test_framework import context

    out = ROOT / "build" / "generators"
    shutil.rmtree(out, ignore_errors=True)
    spec = build_spec(GEN_FORK, GEN_PRESET)

    def run(where: str, flags: list) -> dict:
        # each run computes its own genesis states, shuffles and active sets
        context._state_cache.clear()
        spec._shuffle_cache.clear()
        spec._active_indices_cache.clear()
        attestation = gen_from_tests.get_create_provider_fn("operations")(
            GEN_FORK, GEN_PRESET, "attestation", GEN_CASES)
        ssz = ssz_static.create_provider(GEN_FORK, GEN_PRESET, GEN_SSZ_SEED, RandomizationMode.mode_random,
                                         False, GEN_SSZ_COUNT)
        events(clear=True)
        log: list = []
        t0 = time.perf_counter()
        ops = run_generator("operations", [attestation], ["-o", str(out / where), "--bls-defer", *flags],
                            flush_log=log)
        t1 = time.perf_counter()
        ssz_counts = run_generator("ssz_static", [ssz], ["-o", str(out / where), *flags])
        t2 = time.perf_counter()
        require(len(log) == 1, f"the {where} run flushed {len(log)} times, not once")
        res = {
            "operations": ops, "ssz_static": ssz_counts, "operations_s": t1 - t0, "ssz_static_s": t2 - t1,
            "flush": {k: v for k, v in log[0].items() if k != "rows"},
            "false_rows": sorted(c for c, rows in log[0]["rows"].items() if not all(rows)),
            "retried": [e for e in events() if e["event"] == "retry"],
        }
        for name in ("operations", "ssz_static"):
            c = res[name]
            require(c["failed"] == 0, f"the {where} run failed {c['failed']} {name} cases")
            res[f"{name}_cases_per_s"] = c["generated"] / res[f"{name}_s"]
        require(res["retried"] == [], f"the {where} run retried: {res['retried']}")
        print(f"[generators] {where} run: operations/attestation {ops['generated']} cases in "
              f"{res['operations_s']:.2f}s ({res['operations_cases_per_s']:.3f} cases/s; the flush of "
              f"{log[0]['checks']} checks {log[0]['seconds']:.3f}s wall), ssz_static {ssz_counts['generated']} cases "
              f"in {res['ssz_static_s']:.2f}s ({res['ssz_static_cases_per_s']:.3f} cases/s); invalid-signature "
              f"rows False in {res['false_rows']}, replayed {res['flush']['replayed']}", flush=True)
        return res

    bls_torch.clear_caches()
    dev.reset_counters()
    fq_cuda.reset_counters()
    before_sizes = {k: dict(fq_cuda.sizes[k]) for k in fq_cuda.KERNELS}
    card_run = run("card", [])
    torch.cuda.synchronize()
    sha_launches = dev.counters()["launches"]
    launches = {k: fq_cuda.launches[k] for k in fq_cuda.KERNELS}
    sizes = {k: {n: c - before_sizes[k].get(n, 0) for n, c in fq_cuda.sizes[k].items()
                 if c != before_sizes[k].get(n, 0)} for k in fq_cuda.KERNELS}
    host_run = run("host", ["--device", "host"])
    card, host = gen_tree(out / "card"), gen_tree(out / "host")
    require(card.keys() == host.keys(), f"the card wrote {len(card)} files, the host {len(host)}")
    differ = [name for name in card if card[name] != host[name]]
    require(not differ, f"{len(differ)} files differ between the card and the host, e.g. {differ[:3]}")
    require(CaseJournal(out / "card").entries() == CaseJournal(out / "host").entries(),
            "the journals' entries differ")
    require(card_run["false_rows"] and card_run["false_rows"] == host_run["false_rows"],
            f"invalid-signature rows: card {card_run['false_rows']}, host {host_run['false_rows']}")
    require(sorted(card_run["flush"]["replayed"]) == card_run["false_rows"],
            f"replayed {card_run['flush']['replayed']}, rows False in {card_run['false_rows']}")
    require(sha_launches["sha256_blocks"] > 0, "K1 sha256_blocks was not launched by the generator run")
    missing = [k for k in fq_cuda.KERNELS if launches[k] == 0]
    require(not missing, f"{missing} not launched by the generator run's flush")
    n_bytes = sum(len(b) for b in card.values())
    report["generators"] = {
        "card": card_run, "host": host_run, "files": len(card), "bytes": n_bytes,
        "launches": {**sha_launches, **launches}, "sizes": sizes,
    }
    print(f"[generators] {len(card)} files ({n_bytes} bytes) byte-identical between the card and the host oracle, "
          f"journals equal; 0 failed, 0 retried; launches K1/K2 {sha_launches}, K3-K9 {launches}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches": {**sha_launches, **launches}}, sizes


# Phase 10, kzg: the R&D forks' FFT and KZG checks on the card. The FFT at
# a mainnet DAS blob of MAX_SAMPLES_PER_BLOCK x POINTS_PER_SAMPLE points and
# its extension to twice that; the KZG batches at mainnet's widths on the
# minimal preset's 64-power development setup (mainnet's 16,384 powers are
# ~11 minutes of host scalar multiplications; a row is two pairings
# whatever the setup's size).
FR_SOURCE = "consensus_specs_tpu_torch/ops/csrc/fr_fft.cu"
FR_FFT_REPLACES = "consensus_specs_tpu/ops/fft_jax.py:196"
FR_MUL_REPLACES = "consensus_specs_tpu/ops/fft_jax.py:136"
# the kernels a forward transform's passes and K12's product run, by their
# mangled names ("single": a transform of one pass; K12's product on
# 16-byte aligned tensors, its tiles copied in 16-byte pieces)
FR_SASS = {"fr_mul": "fr_mul_kernelILi0ELb1EE", "first": "fr_fft_pass_kernelILb1ELb0ELb0EE",
           "middle": "fr_fft_pass_kernelILb0ELb0ELb0EE", "last": "fr_fft_pass_kernelILb0ELb1ELb0EE",
           "single": "fr_fft_pass_kernelILb1ELb1ELb0EE"}
# K11's work: its earlier kernel, one launch a stage and one thread a
# butterfly, issued these instructions a butterfly at the first, a middle
# and the last stage (cuobjdump -sass of its build for sm_90a, counted by
# sass_pipes on an H100 80GB HBM3; PERF.md §6). A transform's bound is n/2
# butterflies a stage at these counts, or the pass kernel's own SASS over
# its passes where that is less: the work, not the kernel's way of doing it.
FR_STAGE_KERNEL_BUTTERFLY_ISSUE = {"first": 803, "middle": 701, "last": 821}
# K11's check sizes beyond the main path's: one pass (64), a short last pass
# with two groups a tile (2,048: 6 + 5 stages), three passes (2^17: 6 + 6 + 5)
FR_FFT_CHECK_SIZES = (64, 2048, 1 << 17)
FR_ROW_BYTES, FR_TWIDDLE_BYTES = 4 * fr_plain.N_LIMBS, 4 * fr_cuda.N_WORDS
KZG_TAMPERED, KZG_MALFORMED = 8, 2  # degree-proof and single-opening rows
KZG_COSET_ROWS, KZG_COSET_TAMPERED = 32, 2
DAS_BLOB_POINTS = 16  # a minimal DAS blob: 4 samples of 8 points after extension
# The K3-K9 launches of one pairing call of two-pair rows (bls_torch.run_checks:
# the batched Miller loop, the tree product and the fast final exponentiation;
# K9 once, in tower.fq12_inv), whatever its rows. Counted on the CPU by
# wrapping fq's dispatch (fq.mul, fq._addsub, fq.pow_bits, fq.fq2_pow_bits,
# fq.inv) around one call of three rows.
PAIRING_CALL_LAUNCHES = {"fq_mul": 774, "fq_addsub": 8203, "fq_pow": 0, "fq2_pow": 0, "g1_mul_static": 0,
                         "g2_mul_static": 0, "fq_inv": 1}


def fr_ints(n: int, rng) -> list:
    return [int.from_bytes(rng.bytes(32), "big") % fr_plain.P_INT for _ in range(n)]


def fr_pass_kinds(n: int) -> list:
    """The FR_SASS kind of each of a forward transform's passes."""
    passes = fr_cuda.fft_passes(n)
    if passes == 1:
        return ["single"]
    return ["first"] + ["middle"] * (passes - 2) + ["last"]


def fft_work_cycles(n: int, lib: Path) -> dict:
    """The SM cycles of a forward transform's work at n: the stage kernel's
    butterflies (``FR_STAGE_KERNEL_BUTTERFLY_ISSUE``, n/2 a stage, all
    issue-bound) and the pass kernel's own SASS (``sass_pipes`` of each
    pass's kernel, its stage loop run that pass's stages, n/2 threads a
    pass); the bound takes the less."""
    k = n.bit_length() - 1
    issue = FR_STAGE_KERNEL_BUTTERFLY_ISSUE
    staged = n // 2 * (issue["first"] + (k - 2) * issue["middle"] + issue["last"]) / ISSUE_PER_SM_CLOCK
    own = sum(n // 2 * sass_pipes(lib, FR_SASS[kind], trips=stages, loops=1)["sm_cycles"]
              for kind, (_, stages) in zip(fr_pass_kinds(n), fr_cuda.fft_plan(n)))
    return {"stage_kernel": staged, "own": own, "used": "own" if own < staged else "stage_kernel",
            "cycles": min(own, staged)}


def shifted(x: torch.Tensor, words: int) -> torch.Tensor:
    """A copy of ``x`` as a view ``words`` int32 into its own storage."""
    flat = torch.empty(words + x.numel(), dtype=x.dtype, device=x.device)
    flat[words:] = x.reshape(-1)
    return flat[words:].view(x.shape)


def fr_kernel_checks(card: "Card", rng, sizes: list) -> dict:
    """K12 (each op) at the blob's size on random values with the edge
    values 0, 1 and r - 1 in every pairing as the last rows, a one-element
    operand either side, and an operand only 8-byte aligned (its tiles
    copied in 8-byte pieces), against its plain version on the card and
    Python integers on a sample; K11 forward and inverse at each of ``sizes`` and
    ``FR_FFT_CHECK_SIZES`` (one pass, a short last pass, three passes) and
    the das extension at the first, against their plain versions on the
    card. Then each kernel timed by the profiler (the median of three
    windows) at each of ``sizes``, beside its bound (K12: its SASS per pipe
    or its bytes; K11: ``fft_work_cycles`` or its bytes) and its plain
    version's time: a launch each. A K11 launch is one pass, and its bound
    and plain time are the transform's over its passes; the transform's
    own are kept as ``transform_*``."""
    p = fr_plain.P_INT
    n = sizes[0]
    edges = [(x, y) for x in (0, 1, p - 1) for y in (0, 1, p - 1)]
    ints = [tuple(fr_ints(2, rng)) for _ in range(n - len(edges))] + edges
    av, bv = [x for x, _ in ints], [y for _, y in ints]
    a, b = (torch.from_numpy(fr_plain.to_limbs(v)).cuda() for v in (av, bv))
    sample = list(range(0, n - len(edges), n // 64)) + list(range(n - len(edges), n))
    rinv = pow(fr_plain.R_INT, -1, p)
    refs = {fr_cuda.OP_MUL: (fr_plain.mul, lambda x, y: x * y * rinv % p),
            fr_cuda.OP_ADD: (fr_plain.add, lambda x, y: (x + y) % p),
            fr_cuda.OP_SUB: (fr_plain.sub, lambda x, y: (x - y) % p)}
    errs = {"fr_mul": 0, "fr_fft": 0}
    for op, (plain, ref) in refs.items():
        got = fr_cuda.fr_mul(a, b, op)
        err = max_abs_err(got, plain(a, b))
        require(err == 0, f"fr_mul op {op} disagrees with its plain version at {n} (max abs err {err})")
        require(list(fr_plain.from_limbs(got[sample])) == [ref(av[i], bv[i]) for i in sample],
                f"fr_mul op {op} disagrees with Python integers at {n}")
        for x, y in ((a[:1], b), (a, b[:1])):
            e = max_abs_err(fr_cuda.fr_mul(x, y, op), plain(x, y))
            require(e == 0, f"fr_mul op {op} with a one-element operand disagrees (max abs err {e})")
        e = max_abs_err(fr_cuda.fr_mul(a, shifted(b, 2), op), plain(a, b))
        require(e == 0, f"fr_mul op {op} with an operand only 8-byte aligned disagrees (max abs err {e})")
        errs["fr_mul"] = max(errs["fr_mul"], err)
    for m in list(sizes) + list(FR_FFT_CHECK_SIZES):
        x = fr_plain.to_mont(torch.from_numpy(fr_plain.to_limbs(fr_ints(m, rng))).cuda())
        for inverse in (False, True):
            err = max_abs_err(fr_cuda.fr_fft(x, m, inverse), fr_plain.fft(x, m, inverse))
            require(err == 0, f"fr_fft {'inverse' if inverse else 'forward'} disagrees with its plain version at {m} "
                              f"({fr_cuda.fft_plan(m)} passes; max abs err {err})")
            errs["fr_fft"] = max(errs["fr_fft"], err)
    x = fr_plain.to_mont(torch.from_numpy(fr_plain.to_limbs(fr_ints(n, rng))).cuda())
    err = max_abs_err(fft_torch.das_extension(x, n), fr_plain.das_extension(x, n))
    require(err == 0, f"the das extension on K11 disagrees with its plain version at {n} (max abs err {err})")
    print(f"[kzg] K12 fr_mul (ops mul, add, sub) bit-exact against its plain version at {n} elements with the edge "
          f"pairs of 0, 1, r - 1, a one-element operand and an operand only 8-byte aligned, Python integers on a sample; K11 fr_fft forward and "
          f"inverse at {list(sizes) + list(FR_FFT_CHECK_SIZES)} (passes: "
          f"{ {m: fr_cuda.fft_plan(m) for m in list(sizes) + list(FR_FFT_CHECK_SIZES)} }) and the das extension at "
          f"{n}: {errs}", flush=True)

    lib = fr_cuda.build()
    sass = {"fr_mul": sass_pipes(lib, FR_SASS["fr_mul"])}
    sass.update({k: sass_pipes(lib, FR_SASS[k], trips=1, loops=1) for k in ("first", "middle", "last", "single")})
    print(f"[kzg] SASS a thread (K11 with one stage a pass): "
          + "; ".join(f"{k} {v['alu']} ALU, {v['fma']} FMA, {v['issue']} issued ({v['bound_by_pipe']})"
                      for k, v in sass.items()), flush=True)
    out = {}
    for m in sizes:
        ints = fr_ints(2 * m, rng)
        a, b = (torch.from_numpy(fr_plain.to_limbs(v)).cuda() for v in (ints[:m], ints[m:]))
        x = fr_plain.to_mont(a)
        passes = fr_cuda.fft_passes(m)
        mul_bound = card.sass_bound_ms(m, sass["fr_mul"], 3 * FR_ROW_BYTES * m)
        work = fft_work_cycles(m, lib)
        fft_bound = card.cycles_bound_ms(work["cycles"], 2 * FR_ROW_BYTES * m + FR_TWIDDLE_BYTES * m // 2)
        pass_ms = device_ms(lambda: fr_cuda.fr_fft(x, m), "fr_fft_pass_kernel", per_call=passes)
        fft_plain_ms = once_ms(lambda: fr_plain.fft(x, m))
        recs = {
            "fr_mul": {"ms": device_ms(lambda: fr_cuda.fr_mul(a, b), "fr_mul_kernel"),
                       "plain_ms": cuda_ms(lambda: fr_plain.mul(a, b), reps=3), "bound": mul_bound},
            "fr_fft": {"ms": pass_ms, "plain_ms": fft_plain_ms / passes,
                       "bound": (fft_bound[0] / passes, fft_bound[1]), "launches_a_call": passes,
                       "passes": fr_cuda.fft_plan(m), "work_cycles": work,
                       "transform_ms": pass_ms * passes, "transform_plain_ms": fft_plain_ms,
                       "transform_bound_ms": fft_bound[0]},
        }
        for name, r in recs.items():
            bound, bound_by = r.pop("bound")
            out.setdefault(name, {"max_abs_err": errs[name], "library_ms": None, "by_size": {}})["by_size"][m] = {
                **r, "bound_ms": bound, "bound_by": bound_by}
            print(f"[kzg] {name} at {m} elements: {r['ms'] * 1e3:.3f} us a launch on the card; bound "
                  f"{bound * 1e3:.3f} us ({bound_by}); plain {r['plain_ms']:.3f} ms"
                  + (f"; a transform of {passes} launches {r['transform_ms'] * 1e3:.2f} us, bound "
                     f"{r['transform_bound_ms'] * 1e3:.3f} us (work: the stage kernel's butterflies {work['stage_kernel']:.0f} SM "
                     f"cycles, this kernel's SASS {work['own']:.0f}), plain {fft_plain_ms:.3f} ms"
                     if name == "fr_fft" else ""), flush=True)
    for name, r in out.items():  # the record at the main path's size, the blob's
        keys = ("ms", "plain_ms", "bound_ms", "bound_by") + (("transform_ms",) if name == "fr_fft" else ())
        r.update({k: r["by_size"][n][k] for k in keys}, elements=n, sass=sass)
    return out


def _timed_call(fn) -> tuple:
    """(result or the AssertionError raised, wall s, device s, K3-K9
    launches) of one KZG entry point on the card."""
    bls_torch.reset_stage_seconds()
    before = dict(fq_cuda.launches)
    t0 = time.perf_counter()
    try:
        result = fn()
    except AssertionError as e:
        result = e
    wall = time.perf_counter() - t0
    launches = {k: fq_cuda.launches[k] - before[k] for k in fq_cuda.KERNELS}
    return result, wall, sum(bls_torch.stage_seconds.values()), launches


def _batch_record(label: str, rows: int, fixture_s: float, wall: float, device_s: float, launches: dict) -> dict:
    require(launches == PAIRING_CALL_LAUNCHES,
            f"{label}: the pairing call made {launches} launches, not {PAIRING_CALL_LAUNCHES}")
    rec = {"rows": rows, "fixture_s": fixture_s, "wall_s": wall, "device_s": device_s,
           "host_s": wall - device_s, "rows_per_s": rows / wall, "launches": launches}
    print(f"[kzg] {label}: {rows} rows, fixtures {fixture_s:.2f}s on the host; the call {wall:.2f}s "
          f"({wall - device_s:.2f}s host row-building, {device_s:.3f}s on the card: Miller loop and final "
          f"exponentiation), {rec['rows_per_s']:.1f} rows/s; PAIRING_CALL_LAUNCHES", flush=True)
    return rec


def add_counts(counts: dict, launches: dict) -> dict:
    return {"launches": {k: counts["launches"].get(k, 0) + launches.get(k, 0)
                         for k in set(counts["launches"]) | set(launches)}}


def _named_rows(error) -> list:
    require(isinstance(error, AssertionError), f"the batch was accepted: {error!r}")
    return [int(v) for v in re.search(r"\[([0-9, ]*)\]", str(error)).group(1).split(",") if v.strip()]


def kzg_phase(report: dict, card: "Card", seed: int) -> dict:
    """Phase 10: the R&D forks on the card. Returns the main path's counts
    (K11/K12 from the FFT entry points, K3-K9 from the pairing calls)."""
    rng = np.random.default_rng([seed, 14])
    mainnet = preset_for("mainnet", ["phase0", "altair", "bellatrix", "sharding", "eip4844"])
    spec = build_spec("sharding", "minimal")
    size, pps = int(spec.KZG_SETUP_SIZE), int(spec.POINTS_PER_SAMPLE)
    blob = mainnet["MAX_SAMPLES_PER_BLOCK"] * pps
    out: dict = {}

    # the FFT entry points, Python ints in and out, each against the host oracle
    values = fr_ints(blob, rng)
    fr_cuda.reset_counters()
    t0 = time.perf_counter()
    forward = fft_torch.fft_device(values)
    inverse = fft_torch.fft_device(values, inverse=True)
    extension = fft_torch.das_fft_extension_device(values)
    torch.cuda.synchronize()
    fft_s = time.perf_counter() - t0
    fr_launches = {k: dict(fr_cuda.sizes[k]) for k in fr_cuda.KERNELS}
    counts = {"launches": dict(fr_cuda.launches)}
    t0 = time.perf_counter()
    require(forward == fr.fft(values), f"fft_device disagrees with crypto/fr.fft at {blob}")
    require(inverse == fr.fft(values, inv=True), f"fft_device (inverse) disagrees with crypto/fr.fft at {blob}")
    require(extension == fr.das_fft_extension(values), f"das_fft_extension_device disagrees with the host at {blob}")
    host_s = time.perf_counter() - t0
    passes = fr_cuda.fft_passes  # K11 launches a pass: ceil(log2 n / 8) a transform
    require(passes(blob) <= 3 and passes(2 * blob) <= 3, f"K11 plans {passes(blob)} and {passes(2 * blob)} passes")
    require(fr_launches == {"fr_fft": {blob: 3 * passes(blob), 2 * blob: passes(2 * blob)}, "fr_mul": {blob: 6}},
            f"the FFT entry points launched {fr_launches}")
    out["fft"] = {"n": blob, "card_s": fft_s, "host_oracle_s": host_s, "launches": fr_launches}
    print(f"[kzg] fft_device forward and inverse and das_fft_extension_device at {blob} points on the card in "
          f"{fft_s:.3f}s (K11 {fr_launches['fr_fft']}, K12 {fr_launches['fr_mul']}), equal to crypto/fr's "
          f"({host_s:.2f}s on the host)", flush=True)
    out["kernels"] = fr_kernel_checks(card, rng, [blob, 2 * blob])

    # the pairing batches: every row's verdict exact, one pairing call each
    bls_torch.use_device()
    t0 = time.perf_counter()
    setup = kzg.insecure_setup(size)
    spec.G2_SETUP[0]  # the spec's lazy setup: the same cached one
    out["setup_s"] = time.perf_counter() - t0
    bad_bytes = harness.off_curve_g1_bytes()

    n_rows = mainnet["MAX_SHARD_HEADERS_PER_SHARD"] * mainnet["INITIAL_ACTIVE_SHARDS"]
    picks = [int(i) for i in rng.permutation(n_rows)[: KZG_TAMPERED + KZG_MALFORMED]]
    tampered, malformed = set(picks[:KZG_TAMPERED]), picks[KZG_TAMPERED:]
    t0 = time.perf_counter()
    summaries = []
    for i in range(n_rows):
        count = int(rng.integers(1, size // pps + (0 if i in tampered else 1)))  # tampered: room for count + 1
        coeffs = harness.random_polynomial(rng, count * pps)
        commitment = bad_bytes if i == malformed[0] else harness.kzg_commitment(coeffs)
        proof = harness.degree_proof(coeffs, (count + (i in tampered)) * pps, size)
        data_commitment = spec.DataCommitment(point=commitment, samples_count=count)
        summaries.append(spec.ShardBlobBodySummary(commitment=data_commitment,
                                                   degree_proof=bad_bytes if i == malformed[1] else proof))
    fixture_s = time.perf_counter() - t0
    result, wall, device_s, launches = _timed_call(lambda: spec.verify_degree_proofs(summaries))
    named = _named_rows(result)
    require(named == sorted(picks), f"verify_degree_proofs named rows {named}, not {sorted(picks)}")
    out["degree_proofs"] = {**_batch_record(f"sharding verify_degree_proofs, {KZG_TAMPERED} tampered and "
                                            f"{KZG_MALFORMED} malformed named exactly", n_rows, fixture_s, wall,
                                            device_s, launches), "named": named}
    counts = add_counts(counts, launches)

    blobs = mainnet["MAX_BLOBS_PER_BLOCK"]
    t0 = time.perf_counter()
    cs, ws, xs, ys = [], [], [], []
    for b_i in range(blobs):
        coeffs = harness.random_polynomial(rng, 1 if b_i == 0 else size)  # blob 0 constant: infinity proofs
        commitment = harness.kzg_commitment(coeffs)
        for _ in range(pps):
            x = fr_ints(1, rng)[0]
            y, proof = harness.kzg_single_proof(coeffs, x)
            cs.append(commitment), ws.append(proof), xs.append(x), ys.append(y)
    n_single = len(cs)
    picks = [int(i) for i in rng.permutation(n_single)[: KZG_TAMPERED + KZG_MALFORMED]]
    for i in picks[:KZG_TAMPERED]:
        ys[i] = (ys[i] + 1) % fr.MODULUS
    cs[picks[KZG_TAMPERED]], ws[picks[KZG_TAMPERED + 1]] = bad_bytes, bad_bytes
    fixture_s = time.perf_counter() - t0
    mask, wall, device_s, launches = _timed_call(lambda: kzg_torch.verify_kzg_proof_batch(cs, ws, xs, ys, setup))
    want = [i not in picks for i in range(n_single)]
    require(list(mask) == want, f"verify_kzg_proof_batch: rows {[i for i, v in enumerate(mask) if not v]} False, "
                                f"not {sorted(picks)}")
    out["single"] = _batch_record(f"verify_kzg_proof_batch ({blobs} blobs x {pps} points, {KZG_TAMPERED} wrong y, "
                                  f"{KZG_MALFORMED} malformed, one constant blob's {pps} infinity proofs resolved on "
                                  f"the host), mask exact", n_single, fixture_s, wall, device_s, launches)
    counts = add_counts(counts, launches)
    single_rows = (next(i for i in range(pps, n_single) if want[i]), picks[0])

    t0 = time.perf_counter()
    w_m = fr.root_of_unity(pps)
    c_cs, c_ws, c_x0s, c_yss = [], [], [], []
    for _ in range(KZG_COSET_ROWS):
        coeffs = harness.random_polynomial(rng, size)
        x0 = fr_ints(1, rng)[0]
        yv, proof = harness.kzg_coset_proof(coeffs, [x0 * pow(w_m, j, fr.MODULUS) % fr.MODULUS for j in range(pps)])
        c_cs.append(harness.kzg_commitment(coeffs)), c_ws.append(proof), c_x0s.append(x0), c_yss.append(yv)
    bad_cosets = [int(i) for i in rng.permutation(KZG_COSET_ROWS)[:KZG_COSET_TAMPERED]]
    for i in bad_cosets:
        c_yss[i][3] = (c_yss[i][3] + 1) % fr.MODULUS
    fixture_s = time.perf_counter() - t0
    mask, wall, device_s, launches = _timed_call(
        lambda: kzg_torch.check_multi_kzg_proof_batch(c_cs, c_ws, c_x0s, c_yss, setup))
    want = [i not in bad_cosets for i in range(KZG_COSET_ROWS)]
    require(list(mask) == want, f"check_multi_kzg_proof_batch: mask {list(mask)} not {want}")
    out["coset"] = _batch_record(f"check_multi_kzg_proof_batch (m = {pps}, {KZG_COSET_TAMPERED} tampered), mask exact",
                                 KZG_COSET_ROWS, fixture_s, wall, device_s, launches)
    counts = add_counts(counts, launches)

    das = build_spec("das", "minimal")
    t0 = time.perf_counter()
    extended = das.extend_data(fr_ints(DAS_BLOB_POINTS, rng))
    samples = das.sample_data(3, 1, extended)
    poly = das.ifft(das.reverse_bit_order_list(extended))
    commitment = das.DataCommitment(point=das.commit_to_data(poly), samples_count=len(samples))
    fixture_s = time.perf_counter() - t0
    result, wall, device_s, launches = _timed_call(lambda: das.verify_samples(samples, len(samples), commitment))
    require(result is None, f"das verify_samples rejected untampered samples: {result!r}")
    out["das"] = _batch_record(f"das sample_data -> verify_samples, {len(samples)} samples of a "
                               f"{DAS_BLOB_POINTS}-point blob", len(samples), fixture_s, wall, device_s, launches)
    counts = add_counts(counts, launches)
    bad = samples[2].copy()
    bad.data[0] = (int(bad.data[0]) + 1) % fr.MODULUS
    result, wall, device_s, launches = _timed_call(
        lambda: das.verify_samples(samples[:2] + [bad] + samples[3:], len(samples), commitment))
    require(_named_rows(result) == [2], f"das verify_samples named {result}, not the tampered sample 2")
    out["das_tampered"] = _batch_record("das verify_samples, sample 2 tampered: named exactly", len(samples), 0.0,
                                        wall, device_s, launches)
    counts = add_counts(counts, launches)

    # the host oracle decides one valid and one tampered row of each batch the same
    t0 = time.perf_counter()
    for i in single_rows:
        require(kzg.verify_single(cs[i], ws[i], xs[i], ys[i], setup) == (i not in picks),
                f"crypto/kzg.verify_single disagrees on single row {i}")
    for i in (next(i for i in range(KZG_COSET_ROWS) if i not in bad_cosets), bad_cosets[0]):
        require(kzg.check_multi_kzg_proof(c_cs[i], c_ws[i], c_x0s[i], c_yss[i], setup) == (i not in bad_cosets),
                f"crypto/kzg.check_multi_kzg_proof disagrees on coset row {i}")
    for i in (next(i for i in range(n_rows) if i not in named), sorted(tampered)[0]):
        try:
            spec.verify_degree_proof(summaries[i])
            held = True
        except AssertionError:
            held = False
        require(held == (i not in named), f"the spec's scalar verify_degree_proof disagrees on row {i}")
    out["oracle_s"] = time.perf_counter() - t0
    print(f"[kzg] host oracle (verify_single, check_multi_kzg_proof, the spec's verify_degree_proof) agrees on a "
          f"valid and a tampered row of each batch ({out['oracle_s']:.2f}s)", flush=True)
    report["kzg"] = out
    return counts



def kernel_records(report: dict, main_counts: tuple) -> list:
    """The kernels line: each kernel of the main path with its launches
    there (summed over ``main_counts``, each a phase's ``{"launches": ...}``),
    then the one-thread K3/K4 kept for measurement (launched nowhere on it)."""
    records = []
    for name, replaces, source in (
        ("sha256_blocks", "consensus_specs_tpu/ops/sha256_pallas.py:45", SOURCE),
        ("sha256_raw_blocks", "consensus_specs_tpu/ops/sha256.py:122", SOURCE),
        ("fq_mul", "consensus_specs_tpu/ops/fq.py:175", FQ_SOURCE),
        ("fq_addsub", "consensus_specs_tpu/ops/fq.py:115", FQ_SOURCE),
        ("fq_pow", POW["fq_pow"]["replaces"], FQ_POW_SOURCE),
        ("fq2_pow", POW["fq2_pow"]["replaces"], FQ_POW_SOURCE),
        ("g1_mul_static", LADDER_REPLACES, CURVE_SOURCE),
        ("g2_mul_static", LADDER_REPLACES, CURVE_SOURCE),
        ("fq_inv", INV_REPLACES, FQ_INV_SOURCE),
        ("flag_deltas", FLAG_DELTAS_REPLACES, FLAG_DELTAS_SOURCE),
        ("fr_fft", FR_FFT_REPLACES, FR_SOURCE),
        ("fr_mul", FR_MUL_REPLACES, FR_SOURCE),
        ("add_one", "tools/pallas_probe.py:46", PROBE_SOURCE),
    ):
        if name == "add_one":
            k, launches = report["probe"], report["probe"]["launches"]
        elif name in fr_cuda.KERNELS:
            k = report["kzg"]["kernels"][name]
            launches = sum(c["launches"].get(name, 0) for c in main_counts)
        elif name == "flag_deltas":
            k = report["flag_deltas"]
            launches = sum(c["launches"].get(name, 0) for c in main_counts)
        else:
            if name in fq_cuda.KERNELS:
                k = {**report["timing"][name], "max_abs_err": report["fq_checks"][name]}
            else:
                k = report["kernels"][name]
            launches = sum(c["launches"].get(name, 0) for c in main_counts)
        require(launches > 0, f"{name} was not launched on the main path")
        rec = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            **({"elements": k["elements"]} if name in fq_cuda.KERNELS + fr_cuda.KERNELS else {}),
            **({"transform_ms": k["transform_ms"]} if name == "fr_fft" else {}),
            **({"rows": k["rows"], "call_ms": k["call_ms"]} if name == "flag_deltas" else {}),
        }
        records.append(rec)
    for name, k in report["timing"].items():
        if k.get("measurement_only"):
            replaces = "consensus_specs_tpu/ops/fq.py:175" if name.startswith("fq_mul") else \
                "consensus_specs_tpu/ops/fq.py:115"
            records.append({
                "name": name, "route": "cuda", "source": FQ_SOURCE, "replaces": replaces,
                "launches": 0, "measurement_only": True, "elements": k["elements"],
                "max_abs_err": report["fq_checks"][name], "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None,
            })
    return records


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validators", type=int, default=DEFAULT_VALIDATORS)
    ap.add_argument("--slots", type=int, default=2)  # 2 + 2 phase0 slots leave the altair phase its time
    ap.add_argument("--altair-blocks", type=int, default=1)  # the boundary block 96 alone
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    report: dict = {"args": vars(args), "phase_s": {}}
    t_start = time.perf_counter()
    lap = [t_start]

    def done(phase: str) -> None:
        """Seconds since the last phase ended, kept in report["phase_s"]."""
        now = time.perf_counter()
        report["phase_s"][phase] = now - lap[0]
        lap[0] = now

    phase_build(report)
    card = Card()
    phase_env(report, card)
    done("build and env")
    spec = build_spec("phase0", "mainnet")
    n_blocks = (args.validators + 255) // 256
    k2_rows = spec.SHUFFLE_ROUND_COUNT * (1 + n_blocks)  # the shuffle's one sha256_many_small call
    phase_kernels(report, card, args.seed, k2_rows)
    checked = {"fq": sorted(set(FQ_SIZES) | set(FLUSH_SIZES["fq"])),
               **{name: sorted(set(POW_SIZES) | set(FLUSH_SIZES[name])) for name in (*POW, "fq_inv")},
               **{name: sorted(set(LADDER_SIZES) | set(FLUSH_SIZES[name])) for name in LADDER}}
    label = "1, 130, 260, a decode's 16,385 and the flushes' sizes"
    phase_fq_kernels(report, args.seed, checked["fq"], label)
    phase_pow_kernels(report, args.seed, {name: checked[name] for name in POW}, label)
    phase_inv_kernels(report, args.seed, checked["fq_inv"], label)
    phase_ladder_kernels(report, args.seed, {name: checked[name] for name in LADDER}, label)
    done("kernel checks")

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
    done("calibrate and setup")

    root_counts = state_root_phase(report, spec, states)
    done("state_root")
    transition_counts = transition_phase(report, spec, states, args.slots)
    done("transition")
    expect = FLUSH_LAUNCHES if args.validators == DEFAULT_VALIDATORS else None
    bls_counts, hist = bls_phase(report, spec, states, args.slots, expect)
    tampered_phase(report, spec, states, args.seed)
    done("bls and tampered")
    bls.use_reference()
    dev.use_host_hasher()
    del states, genesis
    altair_counts, altair_hist, k10_calls, variants = chain_phase(
        report, "altair", args.seed, args.validators, args.altair_blocks)
    done("altair")
    capella_counts, capella_hist, _, capella_variants = chain_phase(
        report, "capella", args.seed, args.validators, CAPELLA_BLOCKS)
    done("capella")
    if args.validators == DEFAULT_VALIDATORS:  # both pinned sync calls ran on the card
        require(set(variants + capella_variants) == set(SYNC_CALL_LAUNCHES),
                f"the sync calls ran {variants} (altair) and {capella_variants} (capella), not both variants")
    generator_counts, generator_sizes = generators_phase(report)
    done("generators")
    kzg_counts = kzg_phase(report, card, args.seed)
    done("kzg")
    phase_flag_deltas(report, card, args.seed, k10_calls)
    done("flag_deltas")
    # the checks at every size a flush launched (the phase0, altair, capella
    # and generator flushes) that the kernel checks above did not cover
    sizes = {k: set(altair_hist[k]) | set(capella_hist[k]) | set(hist[k]) | set(generator_sizes[k])
             for k in fq_cuda.KERNELS}
    missing = {"fq": sorted((sizes["fq_mul"] | sizes["fq_addsub"]) - set(checked["fq"])),
               **{name: sorted(sizes[name] - set(checked[name])) for name in (*POW, "fq_inv", *LADDER)}}
    report["flush_sizes_unchecked_before"] = missing
    if any(missing.values()):
        label = "every other size a flush launched"
        phase_fq_kernels(report, args.seed, missing["fq"], label)
        phase_pow_kernels(report, args.seed, {name: missing[name] for name in POW}, label)
        phase_inv_kernels(report, args.seed, missing["fq_inv"], label)
        phase_ladder_kernels(report, args.seed, {name: missing[name] for name in LADDER}, label)
    print(f"[kernels] every size the flushes launched K3-K9 at was checked before them, but {missing}", flush=True)
    done("kernel checks at the flush sizes")
    phase_timing(report, card, args.seed, hist)
    # the flush's histogram, for kernel_turns.py's timings in turns
    FLUSH_RECORD.parent.mkdir(parents=True, exist_ok=True)
    FLUSH_RECORD.write_text(json.dumps({"hist": hist, "card": report["env"]["card"]}, default=str))
    done("timing")
    report["total_s"] = time.perf_counter() - t_start
    print(f"[phases] seconds: { {k: round(v, 1) for k, v in report['phase_s'].items()} }", flush=True)

    records = kernel_records(report, (root_counts, transition_counts, bls_counts, altair_counts, capella_counts,
                                      generator_counts, kzg_counts))
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
        "altair_checks_per_s": report["altair"]["checks_per_s"],
        "altair_epoch_s": report["altair"]["boundary"]["device_epoch_s"],
        "altair_epoch_numpy_s": report["altair"]["boundary"]["host_epoch_s"],
        "capella_checks_per_s": report["capella"]["checks_per_s"],
        "capella_epoch_s": report["capella"]["boundary"]["device_epoch_s"],
        "capella_epoch_numpy_s": report["capella"]["boundary"]["host_epoch_s"],
        "generator_card_s": report["generators"]["card"]["operations_s"] + report["generators"]["card"]["ssz_static_s"],
        "generator_host_s": report["generators"]["host"]["operations_s"] + report["generators"]["host"]["ssz_static_s"],
        "generator_flush_s": report["generators"]["card"]["flush"]["seconds"],
        "kzg_rows_per_s": {k: report["kzg"][k]["rows_per_s"] for k in ("degree_proofs", "single", "coset")},
        "total_s": report["total_s"],
    }))
    print(report["env"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
