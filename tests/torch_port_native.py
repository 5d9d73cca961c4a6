"""A private build of the JAX package's native library for the port's tests.

``ihmr_tpu/native/build.py`` compiles ``_data_kernels.so`` with g++ straight
onto the shared path next to its source, and ``ihmr_tpu.native._load`` takes
any file there that is newer than the source as built. Under ``pytest -n``
several workers build that file at once, and one may load it while another is
still writing it ("file too short"). The loser caches the failure for its
whole process, and ``ihmr_tpu/data/datasets.py`` then quietly letterboxes
with cv2 instead: a port test held to JAX's native path would be held to the
wrong branch.

A port test whose JAX side reaches the native library takes the module
fixture ``private_jax_native``:

    from tests.torch_port_native import private_jax_native  # noqa: F401

    def test_something(private_jax_native): ...

It points JAX's ``build.LIB`` at a file of the module's own temporary
directory, builds it there with JAX's own ``build()`` (its g++ command, not
a copy of it) and loads it with JAX's own ``_load()`` (its ctypes
signatures). No other process writes that file. Everything is put back when
the module ends.
"""

import contextlib
import os

import pytest


@contextlib.contextmanager
def jax_native_built_in(directory):
    """``ihmr_tpu.native`` loaded from a build in ``directory`` for the
    duration -> the module. Raises if it does not load."""
    from ihmr_tpu import native
    from ihmr_tpu.native import build

    os.makedirs(directory, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "LIB", os.path.join(str(directory), os.path.basename(build.LIB)))
        mp.setattr(native, "_tried", False)
        mp.setattr(native, "_lib", None)
        assert native.available(), f"the JAX package's native library did not build in {directory}"
        yield native


@pytest.fixture(scope="module")
def private_jax_native(tmp_path_factory):
    with jax_native_built_in(tmp_path_factory.mktemp("jax_native")) as native:
        yield native
