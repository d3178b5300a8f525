"""Vector-writing runner: CLI, case directories, INCOMPLETE sentinel
lifecycle, resume, error log (ref: gen_helpers/gen_base/gen_runner.py).

Device policy: ``--device cuda`` (the default) installs the torch BLS
backend and the device hasher on the CUDA card before the first provider
runs, and raises when there is no card; ``--device cpu`` installs the same
backends on the kernels' plain PyTorch versions; ``--device host`` runs the
host oracle: the reference BLS and hashlib, nothing on a device.
The run leaves the package defaults (the reference BLS, the host hasher)
installed when it ends.

Deferred-BLS mode (--bls-defer): cases run with the facade's
DeferredVerifier installed, so every signature check records and returns
optimistically instead of dispatching; up to ``--flush-every`` cases'
checks then flush together (planned into the backend's key buckets,
sched/bucketing.py). Cases whose optimistic answers were all genuinely
True commit their buffered parts untouched; the rest replay against the
flushed truth table at zero crypto cost. Output bytes are identical to
the synchronous path by construction.

Resilience (resilience/): every case executes under the supervisor — a
transient fault retries with backoff (recorded in the supervisor's event
log) before the case is counted failed — and committed cases are
journaled (part digests, fsync'd) so a killed run resumes from
verified-complete cases only: output that fails digest or structural
verification (truncated ``.ssz_snappy``, malformed yaml) is regenerated,
never silently shipped.

Committed cases are written by a bounded supervised writer thread
(sched/writer.py; ``--serial-writes`` opts out), so yaml/part IO and the
journal append overlap the next case's compute and the next flush. YAML is
written by ``utils/yaml_emit`` (PyYAML's ``safe_dump`` bytes, without
PyYAML).

Not carried over from the JAX package: ``--workers`` (its workers are
forked, and a process forked after CUDA is initialised cannot use the
card) and ``--profile``; either flag raises.
"""
from __future__ import annotations

import argparse
import shutil
import time
import traceback
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

from ..exceptions import SkippedTest
from ..resilience import CaseJournal, RetryPolicy, supervised
from ..ssz.types import SSZType
from ..utils import snappy, yaml_emit

from .gen_typing import TestCase, TestProvider

# transient-fault budget per case: short backoff — a generator run has
# thousands of cases to get through
CASE_RETRY_POLICY = RetryPolicy(max_attempts=3, base_delay_s=0.05, max_delay_s=1.0)

TIME_THRESHOLD_TO_PRINT = 1.0  # seconds

# bound deferred-case buffering (parts are already-encoded bytes; this is
# a memory bound, not a dispatch bound — one flush still covers a batch)
DEFER_FLUSH_EVERY = 256


def validate_output_dir(path_str: str) -> Path:
    path = Path(path_str)
    if path.exists() and not path.is_dir():
        raise argparse.ArgumentTypeError(f"Output path must be a directory: {path}")
    return path


def _encode_parts(raw_parts) -> Tuple[List[Tuple[str, str, object]], dict]:
    """Materialize a case's yielded parts into write-ready form:
    ssz → snappy-framed bytes, data → jsonable structures, meta → dict.
    Runs INSIDE the case execution window so buffered commits are
    byte-stable regardless of later mutation or replay."""
    from ..debug.encode import encode

    encoded: List[Tuple[str, str, object]] = []
    meta: dict = {}
    for (name, kind, data) in raw_parts:
        if kind == "meta":
            meta[name] = data
        elif kind == "ssz":
            raw = bytes(data.encode_bytes()) if isinstance(data, SSZType) else bytes(data)
            encoded.append((name, "ssz", snappy.compress(raw)))
        elif kind == "data":
            encoded.append((name, "data", encode(data) if isinstance(data, SSZType) else data))
        else:
            raise ValueError(f"unknown part kind {kind!r}")
    return encoded, meta


def _write_case(case_dir: Path, encoded: List[Tuple[str, str, object]], meta: dict) -> int:
    """Write encoded parts under the INCOMPLETE sentinel; returns the
    number of parts written (0 ⇒ caller removes the empty case dir)."""
    case_dir.mkdir(parents=True, exist_ok=True)
    incomplete_tag_file = case_dir / "INCOMPLETE"
    incomplete_tag_file.touch()

    written_parts = 0
    for (name, kind, payload) in encoded:
        written_parts += 1
        if kind == "ssz":
            (case_dir / f"{name}.ssz_snappy").write_bytes(payload)
        else:
            (case_dir / f"{name}.yaml").write_text(yaml_emit.dump(payload))
    if len(meta) != 0:
        written_parts += 1
        (case_dir / "meta.yaml").write_text(yaml_emit.dump(meta))

    if written_parts == 0:
        print(f"test case {case_dir} did not produce any parts, removing")
        shutil.rmtree(case_dir)
    else:
        incomplete_tag_file.unlink()
    return written_parts


class _CaseOutcome:
    """One deferred case awaiting its flush verdict."""

    __slots__ = ("test_case", "case_dir", "encoded", "meta", "error", "marks", "start")

    def __init__(self, test_case, case_dir, encoded, meta, error, marks, start):
        self.test_case = test_case
        self.case_dir = case_dir
        self.encoded = encoded
        self.meta = meta
        self.error = error
        self.marks = marks
        self.start = start


def build_parser(generator_name: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog=f"gen-{generator_name}",
        description=f"Generate YAML/SSZ test-vector suites for {generator_name}",
    )
    parser.add_argument("-o", "--output-dir", dest="output_dir", required=True,
                        type=validate_output_dir, help="directory to write vectors into")
    parser.add_argument("-f", "--force", action="store_true", default=False,
                        help="overwrite existing test cases")
    parser.add_argument("-l", "--preset-list", dest="preset_list", nargs="*", default=None,
                        help="only generate the given presets")
    parser.add_argument("-c", "--collect-only", action="store_true", default=False,
                        help="list the test cases without generating")
    parser.add_argument("--device", choices=("cuda", "cpu", "host"), default="cuda",
                        help="where the torch BLS backend and the device hasher run: the "
                             "CUDA card (default; raises without one) or the CPU (the "
                             "kernels' plain versions); host: the host oracle, the "
                             "reference BLS and hashlib, nothing on a device")
    parser.add_argument("--bls-defer", action="store_true", default=False,
                        help="batch signature checks across cases: run each case "
                             "optimistically, flush all checks together, replay "
                             "only mispredicted cases")
    parser.add_argument("--no-journal", dest="journal", action="store_false",
                        default=True,
                        help="disable the crash-safe case journal (digest-"
                             "verified resume, corruption regeneration)")
    parser.add_argument("--flush-every", type=int, default=DEFER_FLUSH_EVERY,
                        help="deferred-BLS cases to accumulate before one "
                             "bucketed cross-case flush (1 = per-case flush; "
                             f"default {DEFER_FLUSH_EVERY})")
    parser.add_argument("--serial-writes", dest="overlap_writes",
                        action="store_false", default=True,
                        help="write committed cases inline on the main thread "
                             "instead of the bounded overlap writer queue")
    parser.add_argument("--workers", type=int, default=None,
                        help="not available: sharded generation needs spawned "
                             "workers (a forked one cannot use the card); raises")
    parser.add_argument("--profile", action="store_true", default=False,
                        help="not available; raises")
    return parser


def install_backends(device: str) -> None:
    """The torch BLS backend and the device hasher on ``device`` ("cuda":
    the card, raising without one; "cpu": their plain versions), or for
    "host" the reference BLS and the host hasher."""
    from ..crypto import bls
    from ..ops import sha256 as dev

    if device == "host":
        bls.use_reference()
        dev.use_host_hasher()
        return
    where = None if device == "cuda" else device
    dev.use_device_hasher(device=where, calibrate=False)
    bls.use_backend("torch", device=where)


def run_generator(generator_name: str, test_providers: Iterable[TestProvider], args=None,
                  flush_log: Optional[list] = None) -> Dict[str, int]:
    """Write all providers' cases under ``<output>/<case dir>`` with the
    INCOMPLETE sentinel marking in-progress cases and skip-if-exists resume
    (ref gen_runner.py:41-218), on the backends ``--device``
    selects. Returns the generated/skipped/failed counts; exits 1 when a
    case failed. ``flush_log`` (a list) receives one record per deferred
    flush (see ``run_slice``)."""
    ns = build_parser(generator_name).parse_args(args=args)
    if ns.workers is not None:
        raise ValueError("--workers is not available: sharded generation forks its workers, and a "
                         "process forked after CUDA is initialised cannot use the card")
    if ns.profile:
        raise ValueError("--profile is not available")

    from ..crypto import bls
    from ..ops import sha256 as dev

    try:
        if not ns.collect_only:
            install_backends(ns.device)
        counts = run_slice(generator_name, test_providers, ns, flush_log=flush_log)
    finally:
        bls.use_reference()
        dev.use_host_hasher()
    if ns.collect_only:
        return counts
    print(
        f"completed generation of {generator_name}: "
        f"{counts['generated']} generated, {counts['skipped']} skipped, "
        f"{counts['failed']} failed"
    )
    if counts["failed"]:
        raise SystemExit(1)
    return counts


def run_slice(generator_name: str, test_providers: Iterable[TestProvider],
              ns: argparse.Namespace, flush_log: Optional[list] = None) -> Dict[str, int]:
    """One in-process generation pass over the providers' case stream on
    the installed backends. Returns the generated/skipped/failed counts;
    case failures are counted and error-logged, never raised. Each
    deferred flush appends to ``flush_log`` (when given) a record of its
    cases, new checks, wall seconds, each case's rows (the flushed
    results of its checks, by case path) and the cases replayed."""
    output_dir: Path = ns.output_dir
    log_file = output_dir / "testgen_error_log.txt"
    flush_every = max(1, int(ns.flush_every))

    journal = None
    if ns.journal and not ns.collect_only:
        journal = CaseJournal(output_dir)

    counts = {"generated": 0, "skipped": 0, "failed": 0}
    collected = 0

    def rel(case_dir: Path) -> str:
        return str(case_dir.relative_to(output_dir))

    def record_failure(case_dir: Path, err: str) -> None:
        counts["failed"] += 1
        print(f"ERROR in {case_dir}:\n{err}")
        # leave an INCOMPLETE-marked dir so a -f rerun sees the failed case
        case_dir.mkdir(parents=True, exist_ok=True)
        (case_dir / "INCOMPLETE").touch()
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(log_file, "a") as f:
            f.write(f"\n--- {case_dir} ---\n{err}\n")
        if journal is not None:
            journal.invalidate(rel(case_dir))

    def run_case(case_fn) -> Tuple[List[Tuple[str, str, object]], dict]:
        """One case execution under the supervisor: transient faults retry
        with backoff; SkippedTest passes through as control flow, terminal
        faults re-raise into the caller's record_failure path."""
        return supervised(lambda: _encode_parts(case_fn()), domain="generator",
                          policy=CASE_RETRY_POLICY, passthrough=(SkippedTest,))

    def commit_sync(case_dir: Path, encoded, meta, start: float) -> None:
        if _write_case(case_dir, encoded, meta) == 0:
            return
        if journal is not None:
            journal.record(rel(case_dir), case_dir)
        counts["generated"] += 1
        elapsed = time.time() - start
        if elapsed >= TIME_THRESHOLD_TO_PRINT:
            print(f"  done in {elapsed:.2f}s")

    # overlapped serialization (sched/writer.py): part IO + the journal
    # append run on a bounded supervised thread, in submit order
    writer = None
    if ns.overlap_writes and not ns.collect_only:
        from ..sched import CaseWriter

        writer = CaseWriter(commit_sync)

    def commit(case_dir: Path, encoded, meta, start: float) -> None:
        if writer is not None:
            writer.submit(str(case_dir), case_dir, encoded, meta, start)
        else:
            commit_sync(case_dir, encoded, meta, start)

    verifier = None
    if ns.bls_defer and not ns.collect_only:
        from ..crypto import bls

        verifier = bls.DeferredVerifier()

    def run_case_deferred(test_case: TestCase, case_dir: Path, start: float):
        """Execute under deferral, buffering encoded parts. Commits
        immediately when the case recorded no checks; otherwise returns a
        _CaseOutcome for the flush to adjudicate."""
        from ..crypto import bls

        assert verifier is not None
        m0 = verifier.mark()
        encoded, meta, error = None, None, None
        try:
            with bls.deferring(verifier):
                encoded, meta = run_case(test_case.case_fn)
        except SkippedTest as e:
            error = e
        except Exception:
            error = traceback.format_exc()
        m1 = verifier.mark()

        if m0 == m1:  # no signature checks: verdict already final
            finalize_case(case_dir, encoded, meta, error, start)
            return None
        return _CaseOutcome(test_case, case_dir, encoded, meta, error, (m0, m1), start)

    def finalize_case(case_dir, encoded, meta, error, start) -> None:
        if isinstance(error, SkippedTest):
            print(f"skipped: {error}")
            counts["skipped"] += 1
        elif error is not None:
            record_failure(case_dir, error)
        else:
            commit(case_dir, encoded, meta, start)

    def flush_pending(pending: List[_CaseOutcome]) -> None:
        """One batched flush of every recorded check, then commit the
        correctly-predicted cases and replay the rest."""
        from ..crypto import bls

        if not pending:
            return
        assert verifier is not None
        checks = len(verifier.entries) - len(verifier.results)
        t0 = time.perf_counter()
        verifier.flush()
        seconds = time.perf_counter() - t0
        table = verifier.table()
        replayed = []
        for p in pending:
            if p.error is None and verifier.all_true(*p.marks):
                commit(p.case_dir, p.encoded, p.meta, p.start)
                continue
            # misprediction (or an error that may stem from one): replay
            # with true answers — pure-Python re-run, no crypto
            replayed.append(rel(p.case_dir))
            encoded, meta, error = None, None, None
            try:
                with bls.replaying(table):
                    encoded, meta = _encode_parts(p.test_case.case_fn())
            except SkippedTest as e:
                error = e
            except Exception:
                error = traceback.format_exc()
            finalize_case(p.case_dir, encoded, meta, error, p.start)
        if flush_log is not None:
            flush_log.append({
                "cases": len(pending), "checks": checks, "seconds": seconds,
                "rows": {rel(p.case_dir): verifier.results[p.marks[0]:p.marks[1]] for p in pending},
                "replayed": replayed,
            })
        pending.clear()

    # ONE deferred-check population across every provider in the run:
    # providers' prepare() selects nothing the run depends on and each
    # case_fn carries its own (fork, preset) context, so checks from all
    # handlers share a flush
    pending: List[_CaseOutcome] = []
    for provider in test_providers:
        provider.prepare()

        for test_case in provider.make_cases():
            if ns.preset_list is not None and test_case.preset_name not in ns.preset_list:
                continue
            collected += 1
            if ns.collect_only:
                print(test_case.dir_path())
                continue

            case_dir = output_dir / test_case.dir_path()
            incomplete_tag_file = case_dir / "INCOMPLETE"

            if case_dir.exists():
                if not ns.force and not incomplete_tag_file.exists():
                    if journal is None or journal.admit(rel(case_dir), case_dir):
                        counts["skipped"] += 1
                        if journal is not None:
                            # a case admitted on the structural pre-journal
                            # path (its journal append was lost to a kill)
                            # is backfilled so resumes verify digests
                            journal.ensure_recorded(rel(case_dir), case_dir)
                        continue
                    # journal verification failed (truncated/tampered/
                    # unverifiable output): regenerate instead of shipping
                    print(f"regenerating (failed resume verification): {case_dir}")
                shutil.rmtree(case_dir)

            print(f"generating: {case_dir}")
            start = time.time()
            if verifier is not None:
                outcome = run_case_deferred(test_case, case_dir, start)
                if outcome is not None:
                    pending.append(outcome)
                    if len(pending) >= flush_every:
                        flush_pending(pending)
            else:
                encoded, meta, error = None, None, None
                try:
                    encoded, meta = run_case(test_case.case_fn)
                except SkippedTest as e:
                    error = e
                except Exception:
                    error = traceback.format_exc()
                finalize_case(case_dir, encoded, meta, error, start)

    if verifier is not None:
        flush_pending(pending)
    if writer is not None:
        # terminal write failures surface as failed cases, never silently
        # dropped output
        for failed_label, err in writer.close():
            record_failure(Path(failed_label), f"writer failed terminally: {err}")

    if ns.collect_only:
        print(f"collected {collected} test cases")
    return counts
