"""Crash-safe case journal for the vector generator.

The INCOMPLETE sentinel (gen_runner) already marks cases that died
mid-write; what it cannot catch is a case directory that LOOKS complete
but holds corrupted bytes (a truncated ``.ssz_snappy`` after a disk-full
write, a tampered or half-flushed yaml). The journal closes that gap:
every committed case appends one JSON line with the sha256 of each part
file (flushed + fsync'd — a ``kill -9`` can lose at most the in-flight
case, which the sentinel already covers), and a resumed run re-admits a
case only when every journaled digest still matches the bytes on disk.
Cases that fail verification are regenerated, not silently shipped.

Pre-journal corpora (no journal file, or untracked cases) degrade to a
structural check: every ``.ssz_snappy`` must snappy-decompress and every
``.yaml`` must parse (``utils/yaml_emit.parse``, the reader of the YAML
subset the generator writes). That catches truncation and malformed yaml
even with no recorded digests.

Pure stdlib + the in-tree snappy codec and YAML reader.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

from .supervisor import record_event

JOURNAL_NAME = ".gen_journal.jsonl"


def encode_entry(case: str, parts: Dict[str, str]) -> str:
    """The canonical one-line encoding of a journal entry: keys sorted, so
    equal entries are equal bytes."""
    return json.dumps({"case": case, "parts": parts}, sort_keys=True) + "\n"


COMPLETE = "complete"
ABSENT = "absent"
CORRUPT = "corrupt"


def verify_outputs(case_dir: Path) -> Optional[str]:
    """Structural integrity of a case directory (no digests needed):
    None when sound, else the reason it is corrupt."""
    from ..utils import snappy, yaml_emit

    if (case_dir / "INCOMPLETE").exists():
        return "INCOMPLETE sentinel present (crashed mid-write)"
    part_seen = False
    for p in sorted(case_dir.iterdir()):
        if not p.is_file():
            continue
        if p.suffix == ".ssz_snappy":
            part_seen = True
            try:
                snappy.decompress(p.read_bytes())
            except Exception as e:
                return f"{p.name}: undecodable snappy ({type(e).__name__}: {e})"
        elif p.suffix == ".yaml":
            part_seen = True
            try:
                yaml_emit.parse(p.read_text())
            except Exception as e:
                return f"{p.name}: malformed yaml ({type(e).__name__})"
    if not part_seen:
        return "no part files"
    return None


class CaseJournal:
    """Append-only digest journal at ``<output_dir>/.gen_journal.jsonl``."""

    def __init__(self, output_dir: Path, name: str = JOURNAL_NAME):
        self.path = Path(output_dir) / name
        self._entries: Dict[str, Dict[str, str]] = {}
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        with open(self.path, "rb") as f:
            for line in f:
                # a kill mid-append leaves at most one partial trailing
                # line — tolerated, that case just regenerates
                try:
                    entry = json.loads(line)
                    if entry.get("status") == "invalidated":
                        self._entries.pop(entry["case"], None)
                    else:
                        self._entries[entry["case"]] = entry["parts"]
                except (ValueError, KeyError, TypeError):
                    continue

    def _append(self, line: str) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())

    def entries(self) -> Dict[str, Dict[str, str]]:
        """{case rel-path: {part file: sha256 hex}} for every currently
        journaled case — the per-case digest view consumers compare to
        prove byte-identity across runs (the smoke's card and host runs)."""
        return {case: dict(parts) for case, parts in self._entries.items()}

    def record(self, rel: str, case_dir: Path) -> None:
        """Journal a committed case: digest every part file, fsync."""
        parts = {
            p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(case_dir.iterdir())
            if p.is_file()
        }
        self._append(encode_entry(rel, parts))
        self._entries[rel] = parts

    def ensure_recorded(self, rel: str, case_dir: Path) -> None:
        """Backfill a digest entry for a case admitted on the structural
        (pre-journal) path. A kill in the window between a case's last
        part write and its journal fsync leaves a fully-written case dir
        with no entry; without backfill the case would be admitted on
        resume yet stay invisible to digest verification."""
        if rel not in self._entries:
            self.record(rel, case_dir)

    def invalidate(self, rel: str) -> None:
        """Drop a case from the journal (it failed or was removed)."""
        if rel in self._entries:
            self._append(json.dumps({"case": rel, "status": "invalidated"}, sort_keys=True) + "\n")
            del self._entries[rel]

    def status(self, rel: str, case_dir: Path) -> Tuple[str, str]:
        """(COMPLETE | ABSENT | CORRUPT, reason) for one case dir."""
        if not case_dir.exists():
            return ABSENT, ""
        if (case_dir / "INCOMPLETE").exists():
            return CORRUPT, "INCOMPLETE sentinel present (crashed mid-write)"
        parts = self._entries.get(rel)
        if parts is None:
            # pre-journal case: structural check only
            reason = verify_outputs(case_dir)
            if reason is None:
                return COMPLETE, ""
            return CORRUPT, reason
        for name, want in parts.items():
            p = case_dir / name
            if not p.exists():
                return CORRUPT, f"{name}: journaled part missing"
            got = hashlib.sha256(p.read_bytes()).hexdigest()
            if got != want:
                return CORRUPT, f"{name}: digest mismatch (truncated or tampered)"
        stray = {p.name for p in case_dir.iterdir() if p.is_file()} - set(parts)
        if stray:
            return CORRUPT, f"unjournaled stray parts: {sorted(stray)}"
        return COMPLETE, ""

    def admit(self, rel: str, case_dir: Path) -> bool:
        """Resume decision: True to skip (verified complete), False to
        regenerate — recording WHY when the case was corrupt."""
        status, reason = self.status(rel, case_dir)
        if status == COMPLETE:
            return True
        if status == CORRUPT:
            record_event("regenerate", domain="generator",
                         kind="deterministic", detail=f"{rel}: {reason}")
        return False
