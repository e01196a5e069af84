"""The port's kernel build helper with a stand-in compiler: libraries keyed
by the source's hash, errors raised with the compiler's output.  (The
real nvcc runs only on the card's host, in chip_smoke.py.)"""

import pytest

from repro_torch.kernels import _build

FAKE_NVCC = """#!/bin/sh
# Stand-in for nvcc: ... -o OUT SRC; logs each call, fails on 'boom'.
while [ $# -gt 2 ]; do shift; done
echo "$2" >> "{log}"
if grep -q boom "$2"; then echo "error: boom in $2"; exit 2; fi
cp "$2" "$1"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return tmp_path, lambda: log.read_text().split()


def test_build_is_keyed_by_the_source_hash(fake_build):
    tmp, calls = fake_build
    src = tmp / "a.cu"
    src.write_text("// a\n")
    first = _build.build(src)
    assert first.exists() and first.name.startswith("a-")
    assert _build.build(src) == first and calls() == [str(src)]
    src.write_text("// a, edited\n")
    again = _build.build(src)
    assert again != first and calls() == [str(src)] * 2


def test_build_key_covers_the_shared_headers(fake_build):
    """A source may include any ``*.cuh`` beside it: changing a header's
    bytes changes the library's key, so the next build compiles anew."""
    tmp, calls = fake_build
    src = tmp / "a.cu"
    src.write_text('#include "loop.cuh"\n')
    header = tmp / "loop.cuh"
    header.write_text("// loop, first version\n")
    first = _build.build(src)
    assert _build.library_path(src) == first
    header.write_text("// loop, second version\n")
    assert _build.library_path(src) != first
    again = _build.build(src)
    assert again != first and calls() == [str(src)] * 2


def test_build_raises_with_the_compiler_output(fake_build):
    tmp, _ = fake_build
    bad = tmp / "bad.cu"
    bad.write_text("// boom\n")
    with pytest.raises(RuntimeError, match="bad.cu") as err:
        _build.build(bad)
    assert "error: boom" in str(err.value)
    assert not list((tmp / "build").glob("*.so"))


def test_kernel_sources_live_in_csrc():
    from repro_torch.kernels import ca_mmm, flash_attn

    for src in (ca_mmm.SOURCE, ca_mmm.K_OUTER_SOURCE, flash_attn.SOURCE,
                flash_attn.FWD_SOURCE, ca_mmm.DISTANCE_SOURCE):
        assert src.parent == _build.CSRC and src.exists()
    # The TMA + WGMMA main loop K1 and K4 share.
    header = _build.CSRC / "wgmma_mainloop.cuh"
    for src in (ca_mmm.SOURCE, ca_mmm.K_OUTER_SOURCE):
        assert f'#include "{header.name}"' in src.read_text()


def test_distance_product_has_its_own_source():
    """The distance product (K1g) is a kernel of its own: the GEMM
    program's source no longer holds a min-plus template flag or entry
    point, and the distance product's source includes no GEMM header."""
    from repro_torch.kernels import ca_mmm

    gemm = ca_mmm.SOURCE.read_text()
    assert "MIN_PLUS" not in gemm and "min_plus_launch" not in gemm
    dist = ca_mmm.DISTANCE_SOURCE.read_text()
    assert 'extern "C" int distance_product_launch(' in dist
    assert "#include \"" not in dist


PARTS_NVCC = """#!/bin/sh
# Stand-in for nvcc: logs each call's arguments on a line, writes the file
# after -o, fails a compile of part 1 when the source says 'boom1'.
echo "$@" >> "{log}"
out=""
part=""
last=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    -DNVCC_PART=*) part="${{1#-DNVCC_PART=}}" ;;
  esac
  last="$1"
  shift
done
if [ "$part" = 1 ] && grep -q boom1 "$last"; then
  echo "error: boom in part 1"; exit 2
fi
echo "object" > "$out"
"""


@pytest.fixture
def parts_build(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(PARTS_NVCC.format(log=log))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return tmp_path, lambda: [line.split()
                              for line in log.read_text().splitlines()]


def test_a_source_with_parts_compiles_each_part_then_links(parts_build):
    """``// nvcc parts: 3``: three ``-c -DNVCC_PART=i`` compiles (no
    ``-shared``), then one link of their objects into the library, and no
    object left behind."""
    tmp, calls = parts_build
    src = tmp / "k.cu"
    src.write_text("// nvcc parts: 3\n// k\n")
    assert _build.parts(src) == 3
    lib = _build.build(src)
    assert lib.exists() and lib == _build.library_path(src)
    *compiles, link = calls()
    assert sorted(a for c in compiles for a in c
                  if a.startswith("-DNVCC_PART=")) == [
        "-DNVCC_PART=0", "-DNVCC_PART=1", "-DNVCC_PART=2"]
    for c in compiles:
        assert "-c" in c and "-shared" not in c and c[-1] == str(src)
    objs = [c[c.index("-o") + 1] for c in compiles]
    assert "-shared" in link and sorted(link[-3:]) == sorted(objs)
    assert link[link.index("-o") + 1].endswith(".tmp")
    assert not list((tmp / "build").glob("*.o"))
    assert len(_build.PART_SECONDS["k.cu"]) == 3
    assert _build.build(src) == lib and len(calls()) == 4


def test_a_failing_part_raises_and_leaves_nothing(parts_build):
    tmp, _ = parts_build
    src = tmp / "k.cu"
    src.write_text("// nvcc parts: 2\n// boom1\n")
    with pytest.raises(RuntimeError, match="k.cu") as err:
        _build.build(src)
    assert "error: boom in part 1" in str(err.value)
    assert not list((tmp / "build").iterdir())


def test_gemm_program_source_splits_into_parts():
    """K1's source is compiled in parts: part 0 holds the C entry points,
    and every family launcher the entry point calls is defined in exactly
    one part."""
    import re

    from repro_torch.kernels import ca_mmm

    text = ca_mmm.SOURCE.read_text()
    n = _build.parts(ca_mmm.SOURCE)
    assert n == 11
    assert re.search(r"#if IN_PART\(0\)\n// C entry point", text)
    declared = re.findall(r"^int (ca_gemm_\w+)\(const void\* p", text, re.M)
    assert len(declared) == n - 1
    for name in declared:
        defs = re.findall(rf'extern "C" int {name}\(|SIMT_PART\({name},',
                          text)
        assert len(defs) == 1, name
    guarded = sorted(int(i) for i in re.findall(r"#if IN_PART\((\d+)\)",
                                                text))
    assert set(guarded) == set(range(n))
