"""Native SA-IS variants agree with each other and with numpy argsort
of all suffixes — including the uint32-storage variant that production
only exercises at n >= 2^31 (a transcription bug there would otherwise
surface only inside an 85-minute whole-genome build; advisor r4)."""

import ctypes

import numpy as np
import pytest

from salt_tpu.utils.native import load_native

pytestmark = pytest.mark.quick


def _suffix_array_oracle(text: np.ndarray) -> np.ndarray:
    n = len(text)
    suf = sorted(range(n), key=lambda i: text[i:].tobytes())
    return np.array(suf, dtype=np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [2, 4, 16])
def test_sais_variants_agree(seed, alpha):
    lib = load_native()
    if lib is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(seed)
    for n in (1, 2, 5, 64, 1000, 4097):
        # unique terminator (SA-IS requirement mirrors production use:
        # the builder appends a sentinel smaller than all symbols)
        text = (rng.integers(1, alpha + 1, n).astype(np.uint8))
        text[-1] = 0
        sa64 = np.zeros(n, np.int64)
        sa32 = np.zeros(n, np.int32)
        sau = np.zeros(n, np.uint32)
        assert lib.salt_sais_u8(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n)) == 0
        assert lib.salt_sais_u8_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n)) == 0
        assert lib.salt_sais_u8_u32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sau.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(n)) == 0
        assert np.array_equal(sa64, sa32.astype(np.int64)), (n, alpha)
        assert np.array_equal(sa64, sau.astype(np.int64)), (n, alpha)
        if n <= 1000:
            assert np.array_equal(sa64, _suffix_array_oracle(text)), (n, alpha)


def test_sais_u32_repetitive():
    """Highly repetitive texts drive the deepest SA-IS recursion — the
    u32 EMPTY32 sentinel handling must survive them."""
    lib = load_native()
    if lib is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(9)
    unit = rng.integers(1, 4, 7).astype(np.uint8)
    text = np.tile(unit, 600).astype(np.uint8)
    text[-1] = 0
    n = len(text)
    sa64 = np.zeros(n, np.int64)
    sau = np.zeros(n, np.uint32)
    lib.salt_sais_u8(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n))
    lib.salt_sais_u8_u32(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sau.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(n))
    assert np.array_equal(sa64, sau.astype(np.int64))


def test_concurrent_first_builds_all_load(tmp_path):
    """Several processes that find no library build it at once; every
    one of them must end up loading it (no partial-file races)."""
    import os
    import shutil
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    (tmp_path / "tools").mkdir()
    (tmp_path / "salt_tpu" / "utils").mkdir(parents=True)
    for src in ("sais.cpp", "ssw_native.cpp"):
        shutil.copy(os.path.join(repo, "tools", src), tmp_path / "tools")
    native = tmp_path / "salt_tpu" / "utils" / "native.py"
    shutil.copy(os.path.join(repo, "salt_tpu", "utils", "native.py"), native)
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('n', {str(native)!r})\n"
        "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
        "print('LOADED' if m.load_native() is not None else 'FALLBACK')\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [o.strip() for o, _ in outs] == ["LOADED"] * 4, outs
    assert not list((tmp_path / "tools").glob("*.tmp"))
