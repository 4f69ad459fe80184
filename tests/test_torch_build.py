"""
The build directory of the port's CUDA kernels (gordo_tpu_torch/ops/_build.py)
changes with every source and header it compiles, so an edited header never
loads a library built from the old one. Runs on the CPU: nothing is compiled.
"""

import shutil

import pytest

from gordo_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_the_sources_include_a_header():
    assert sorted(p.name for p in _build.CSRC.glob("*.cuh")) == ["head_dim.cuh",
                                                                 "mma_tf32x3.cuh",
                                                                 "wgmma_bf16.cuh"]


@pytest.mark.parametrize("name", ["mma_tf32x3.cuh", "flash_attention.cu",
                                  "flash_attention_bwd.cu", "flash_attention_bf16.cu",
                                  "flash_attention_bwd_bf16.cu", "wgmma_bf16.cuh",
                                  "head_dim.cuh", "lstm_recurrence.cu"])
def test_build_dir_changes_with_each_source_and_header(csrc, name):
    before = _build._build_dir()
    assert _build._build_dir() == before  # stable while nothing changes
    path = csrc / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build._build_dir() != before


def test_build_dir_ignores_other_files(csrc):
    before = _build._build_dir()
    (csrc / "notes.txt").write_text("not a source")
    assert _build._build_dir() == before


def _variants(script: str = "torch_bf16_variants"):
    """scripts/<script>.py, imported by path (stdlib only at import time)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / f"{script}.py"
    spec = importlib.util.spec_from_file_location(script, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", sorted(_variants().VARIANTS))
def test_each_bf16_variant_patch_applies_to_the_sources(name):
    """Every text a variant replaces occurs exactly once in its file, as the
    script requires before it compiles the variant on the card."""
    variants = _variants()
    for file, old, new in variants.VARIANTS[name]:
        assert old != new
        assert (_build.CSRC / file).read_text().count(old) == 1, (name, file)


@pytest.mark.parametrize("name", sorted(_variants("torch_lstm_act_variants").VARIANTS))
def test_each_lstm_variant_patch_applies_to_the_source(name):
    """Every text an LSTM recurrence variant replaces occurs exactly once in
    the source, as scripts/torch_lstm_act_variants.py requires."""
    variants = _variants("torch_lstm_act_variants")
    for old, new in variants.VARIANTS[name]:
        assert old != new
        assert (_build.CSRC / variants.SOURCE).read_text().count(old) == 1, name
