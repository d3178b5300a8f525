"""The port stands alone: no module of consensus_specs_tpu_torch imports
JAX, the JAX package or PyYAML, importing it loads none of them, and its
entry points run on the CUDA card unless a caller asks for the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import consensus_specs_tpu_torch
from consensus_specs_tpu_torch import engine, probe
from consensus_specs_tpu_torch.crypto import bls
from consensus_specs_tpu_torch.engine import delta_checks, ops_torch
from consensus_specs_tpu_torch.ops import bls_torch, fft_torch, fq_cuda, fr_cuda, h2c_torch
from consensus_specs_tpu_torch.ops import sha256 as tdev
from consensus_specs_tpu_torch.ops import sha256_cuda

PACKAGE = Path(consensus_specs_tpu_torch.__file__).parent
FORBIDDEN = {"jax", "jaxlib", "consensus_specs_tpu", "yaml"}


def _imported_top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_the_jax_package_or_yaml():
    sources = sorted(PACKAGE.rglob("*.py"))
    assert len(sources) > 20
    offenders = {str(p.relative_to(PACKAGE)): _imported_top_names(p) & FORBIDDEN for p in sources}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_the_port_loads_neither():
    code = (
        "import sys\n"
        "import consensus_specs_tpu_torch, consensus_specs_tpu_torch.harness, consensus_specs_tpu_torch.interop\n"
        "from consensus_specs_tpu_torch.ops import sha256, sha256_cuda, sha256_plain\n"
        "from consensus_specs_tpu_torch.ops import fq, fq_cuda, fq_plain, tower, curve_torch, h2c_torch\n"
        "from consensus_specs_tpu_torch.ops import pairing_torch, bls_torch, ladder_checks\n"
        "from consensus_specs_tpu_torch.ops import fft_torch, fr_cuda, fr_plain, kzg_torch\n"
        "from consensus_specs_tpu_torch.crypto import fr, kzg\n"
        "from consensus_specs_tpu_torch import probe, sched, engine\n"
        "from consensus_specs_tpu_torch.engine import backend, crosscheck, delta_checks, ops_torch, stages\n"
        "from consensus_specs_tpu_torch.crypto import bls\n"
        "bls.use_backend('torch', device='cpu')\n"
        "from consensus_specs_tpu_torch.specs import build_spec\n"
        "spec = build_spec('phase0', 'minimal')\n"
        "assert spec.__name__ == 'consensus_specs_tpu_torch.specs.phase0_minimal', spec.__name__\n"
        "engine.use_vectorized_epoch(); engine.use_batched_attestations()\n"
        "engine.use_backend('torch', device='cpu')\n"
        "spec = build_spec('altair', 'minimal')\n"
        "assert spec.__name__ == 'consensus_specs_tpu_torch.specs.altair_minimal', spec.__name__\n"
        "assert all(engine.stage_status(spec).values()) and spec.process_operations.engine_batched_atts\n"
        "for fork in ('bellatrix', 'capella'):\n"
        "    spec = build_spec(fork, 'minimal')\n"
        "    assert spec.__name__ == f'consensus_specs_tpu_torch.specs.{fork}_minimal', spec.__name__\n"
        "    assert all(engine.stage_status(spec).values()) and spec.process_operations.engine_batched_atts\n"
        "assert engine.stage_status(spec)['process_full_withdrawals']\n"
        "for fork in ('sharding', 'custody_game', 'das', 'eip4844'):\n"
        "    spec = build_spec(fork, 'minimal')\n"
        "    assert spec.__name__ == f'consensus_specs_tpu_torch.specs.{fork}_minimal', spec.__name__\n"
        "spec = build_spec('eip4844', 'minimal')\n"
        "spec.blob_to_kzg(spec.Blob([1, 2, 3, 4]))  # the in-function imports of the copied sources\n"
        "assert fft_torch.fft_device([1, 2, 3, 4], device='cpu') == fr.fft([1, 2, 3, 4])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'consensus_specs_tpu', 'yaml'})\n"
        "assert not bad, bad\n"
        "assert sha256_cuda._lib is None  # nothing built at import\n"
        "assert fq_cuda._lib is None and fq_cuda._pow_lib is None and fq_cuda._curve_lib is None\n"
        "assert probe._lib is None and ops_torch._lib is None and fr_cuda._lib is None\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_importing_the_generators_loads_none():
    code = (
        "import sys\n"
        "import consensus_specs_tpu_torch.generators.main\n"
        "from consensus_specs_tpu_torch.generators import gen_runner, gen_from_tests, gen_typing\n"
        "from consensus_specs_tpu_torch.generators.runners import operations, ssz_static\n"
        "from consensus_specs_tpu_torch.cases import operations_attestation\n"
        "from consensus_specs_tpu_torch.test_framework import attestations, block, context, execution_payload\n"
        "from consensus_specs_tpu_torch import resilience, exceptions\n"
        "from consensus_specs_tpu_torch.resilience import journal, supervisor, taxonomy\n"
        "from consensus_specs_tpu_torch.sched import CaseWriter\n"
        "from consensus_specs_tpu_torch.debug import decode, encode, random_value\n"
        "from consensus_specs_tpu_torch.utils import snappy, yaml_emit\n"
        "yaml_emit.dump({'a': [1]}); yaml_emit.parse('a: [1]\\n')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in {'jax', 'jaxlib', 'consensus_specs_tpu', 'yaml'})\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PACKAGE.parent, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_generator_entry_point_defaults_to_cuda(monkeypatch, tmp_path):
    from consensus_specs_tpu_torch.generators import main as gen_main
    from consensus_specs_tpu_torch.generators.gen_runner import run_generator
    from consensus_specs_tpu_torch.ssz import hashing

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen_main.main(["-o", str(tmp_path), "--runners", "ssz_static"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_generator("ssz_static", [], ["-o", str(tmp_path)])
    assert bls.backend_name() == "reference" and hashing.backend_name() == "hashlib"
    assert list(tmp_path.iterdir()) == []  # nothing written
    # asked for the CPU, the same entry point runs (on no providers here)
    assert run_generator("ssz_static", [], ["-o", str(tmp_path), "--device", "cpu"]) == \
        {"generated": 0, "skipped": 0, "failed": 0}


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        consensus_specs_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.use_device_hasher()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.hash_many_device(b"\x00" * 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        h2c_torch.hash_to_g2_batch([b""])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.probe()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.use_backend("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops_torch.flag_deltas(*delta_checks.columns(4, 0), *delta_checks.SCALARS[0], False, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fft_torch.fft_device([1, 2, 3, 4])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fft_torch.das_fft_extension_device([1, 2, 3, 4])
    prev = bls_torch._device
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bls.use_backend("torch")
    finally:
        bls.use_reference()
        bls_torch._device = prev
    assert consensus_specs_tpu_torch.resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    before = dict(sha256_cuda.launches)
    for kernel in (sha256_cuda.sha256_blocks, sha256_cuda.sha256_raw_blocks):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernel(torch.zeros((1, 16), dtype=torch.int32))
    assert sha256_cuda.launches == before
    before = dict(fq_cuda.launches)
    x = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq_cuda.fq_mul(x, x)
    for op in (0, 1, 2):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fq_cuda.fq_addsub(x, x, op)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq_cuda.fq_pow(x, [1, 0, 1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq_cuda.fq2_pow(x.view(1, 2, 32), [1, 0, 1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fq_cuda.fq_inv(x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fq_cuda.g1_mul_static((x, x, x), 5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fq_cuda.g2_mul_static((x.view(1, 2, 32),) * 3, 5)
    assert fq_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops_torch.flag_deltas_cuda(x[0].long(), x[0].bool(), x[0].bool(), 1, 1, 1, 1, 1, False, True)
    assert ops_torch.launches["flag_deltas"] == 0
    before = dict(fr_cuda.launches)
    y = torch.zeros((4, 22), dtype=torch.int32)
    for op in (fr_cuda.OP_MUL, fr_cuda.OP_ADD, fr_cuda.OP_SUB):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fr_cuda.fr_mul(y, y, op)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fr_cuda.fr_fft(y, 4)
    assert fr_cuda.launches == before
    # the probe's wrapper takes its plain version for a CPU tensor, and counts no launch
    assert torch.equal(probe.add_one(x), x + 1) and probe.launches["add_one"] == 0
