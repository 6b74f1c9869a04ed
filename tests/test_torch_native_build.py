"""The port's native library builds safely when several processes use it first at once.

Six spawned processes call `load_library()` together on an empty WAX_TPU_NATIVE_DIR.
Each must get a library, and the directory must then hold exactly one `.so` and no
object files: builds serialise on a lock, compile in private directories and publish
the library with one atomic rename.
"""
import multiprocessing as mp
import shutil

import pytest

N_PROCS = 6


def _load(native_dir: str, barrier) -> bool:
    import os

    os.environ["WAX_TPU_NATIVE_DIR"] = native_dir
    from wax_tpu_torch.native.build import load_library

    barrier.wait()
    return load_library() is not None


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_concurrent_first_use_gives_every_process_a_library(tmp_path):
    native_dir = tmp_path / "native"
    ctx = mp.get_context("spawn")
    with ctx.Manager() as manager, ctx.Pool(N_PROCS) as pool:
        barrier = manager.Barrier(N_PROCS)
        got = pool.starmap(_load, [(str(native_dir), barrier)] * N_PROCS)
    assert got == [True] * N_PROCS
    assert len(list(native_dir.glob("*.so"))) == 1
    assert not list(native_dir.rglob("*.o"))
    assert [p.name for p in native_dir.iterdir() if p.is_dir()] == []
