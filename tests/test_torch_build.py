"""
The build directory of the port's CUDA kernels (gordo_tpu_torch/ops/_build.py)
changes with every source and header it compiles, so an edited header never
loads a library built from the old one. Runs on the CPU: nothing is compiled.
"""

import shutil
from pathlib import Path

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
                                                                 "lstm_plan.cuh",
                                                                 "mma_tf32x3.cuh",
                                                                 "wgmma_bf16.cuh"]


@pytest.mark.parametrize("name", ["mma_tf32x3.cuh", "flash_attention.cu",
                                  "flash_attention_bwd.cu", "flash_attention_bf16.cu",
                                  "flash_attention_bwd_bf16.cu", "wgmma_bf16.cuh",
                                  "head_dim.cuh", "lstm_recurrence.cu", "lstm_plan.cuh"])
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


# A stand-in for nvcc: records its arguments and the times it ran, fails
# where FAIL_ON is among them, and otherwise writes its output file
FAKE_NVCC = """#!{python}
import json, sys, time
args = sys.argv[1:]
started = time.time()
if "-c" in args:
    time.sleep(1.0)
with open({log!r}, "a") as f:
    f.write(json.dumps({{"args": args, "started": started, "ended": time.time()}}) + "\\n")
if {fail!r} in args:
    print("error: {fail}")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("built")
print("ptxas info    : Used 40 registers")
"""


def _fake_nvcc(tmp_path, monkeypatch, fail="none"):
    import json
    import sys

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log), fail=fail))
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return lambda: [json.loads(line) for line in log.read_text().splitlines()]


def test_a_source_in_parts_is_compiled_at_once_and_linked_into_one_library(
        csrc, tmp_path, monkeypatch):
    """Each source of PARTS compiles as that many translation units
    (-DGORDO_PART=0..n-1, -c, no -shared), started with every other source
    before any is waited for, then links into its one library; each other
    source is one nvcc to its library."""
    calls = _fake_nvcc(tmp_path, monkeypatch)
    libs = _build.build_all()
    runs = calls()
    assert _build.PARTS["lstm_recurrence"] > 1
    assert set(_build.PARTS) >= {"lstm_recurrence", "flash_attention_bf16",
                                 "flash_attention_bwd_bf16"}
    compiled = [r for r in runs if "-c" in r["args"]]
    links = [r for r in runs if "-c" not in r["args"] and not r["args"][-1].endswith(".cu")]
    assert len(links) == len(_build.PARTS) and all("-shared" in r["args"] for r in links)
    for stem, parts in _build.PARTS.items():
        mine = [r for r in compiled if r["args"][-1].endswith(f"/{stem}.cu")]
        assert sorted(a for r in mine for a in r["args"] if a.startswith("-DGORDO_PART=")) == [
            f"-DGORDO_PART={i}" for i in range(parts)]
        assert all("-shared" not in r["args"] for r in mine)
        link, = [r for r in links
                 if Path(r["args"][r["args"].index("-o") + 1]).name.startswith(f"lib{stem}.tmp-")]
        assert sorted(Path(a).name.split(".")[1] for a in link["args"] if a.endswith(".o")) == [
            f"part{i}" for i in range(parts)]
        assert _build.BUILD_LOGS[stem].count("Used 40 registers") == parts + 1
    whole = {Path(r["args"][-1]).stem for r in runs if r["args"][-1].endswith(".cu")
             and "-c" not in r["args"]}
    assert whole == {p.stem for p in csrc.glob("*.cu")} - set(_build.PARTS)
    # every part started before the first ended: compiled at once
    assert max(r["started"] for r in compiled) < min(r["ended"] for r in compiled)
    assert sorted(libs) == sorted(p.stem for p in csrc.glob("*.cu"))
    assert all(lib.read_text() == "built" for lib in libs.values())
    assert not list(libs["lstm_recurrence"].parent.glob("*.o"))  # the objects are removed


def test_a_failed_part_leaves_no_library_and_names_its_source(csrc, tmp_path, monkeypatch):
    """One part that fails to compile fails the build, naming the source:
    its library is not linked, the other sources' libraries are built
    (part 4: lstm_recurrence.cu is the one source with five parts)."""
    assert [stem for stem, parts in _build.PARTS.items() if parts > 4] == ["lstm_recurrence"]
    _fake_nvcc(tmp_path, monkeypatch, fail="-DGORDO_PART=4")
    with pytest.raises(RuntimeError, match="nvcc failed on lstm_recurrence.cu"):
        _build.build_all()
    built = {p.name for p in _build._build_dir().glob("*.so")}
    assert built == {f"lib{p.stem}.so" for p in csrc.glob("*.cu")} - {"liblstm_recurrence.so"}
    assert not list(_build._build_dir().glob("*.o"))


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
