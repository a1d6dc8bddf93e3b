"""The port's runtime (``pytorchhessianfree_tpu_torch.runtime``): the native
loader built by g++ from the port's own ``csrc/batcher.cpp`` and the device
prefetcher, case by case against ``tests/test_runtime_loader.py``; the
loader's batches bitwise equal to the JAX package's at the same seed; and
the ``.npy`` -> loader -> prefetcher -> HF step path against the JAX one in
f64."""

import threading
import traceback
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.models import init_mlp as j_init_mlp  # noqa: E402
from pytorchhessianfree_tpu.models import mlp_apply as j_mlp_apply  # noqa: E402
from pytorchhessianfree_tpu.models import mse_loss as j_mse  # noqa: E402
from pytorchhessianfree_tpu.runtime import (  # noqa: E402
    DevicePrefetcher as JPrefetcher,
)
from pytorchhessianfree_tpu.runtime import (  # noqa: E402
    PrefetchLoader as JLoader,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import mlp_apply, mse_loss  # noqa: E402
from pytorchhessianfree_tpu_torch.runtime import (  # noqa: E402
    DevicePrefetcher,
    PrefetchLoader,
)


def _dataset(n=64, d=5):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    # encode the sample index in the target so coverage can be checked
    y = np.arange(n, dtype=np.float32).reshape(n, 1)
    return x, y


def _cpu(source, **kwargs):
    return DevicePrefetcher(source, device="cpu", **kwargs)


def test_library_builds_into_the_build_directory():
    from pytorchhessianfree_tpu_torch import _build

    lib = _build.build("batcher.cpp")
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert lib == _build.library_path("batcher.cpp")
    assert not (_build.CSRC / "libhfbatcher.so").exists()


def test_shapes_and_epoch_coverage():
    x, y = _dataset(n=64)
    loader = PrefetchLoader(x, y, batch_size=16, seed=7)
    assert loader.batches_per_epoch == 4

    seen = []
    for _ in range(loader.batches_per_epoch):
        bx, by = loader.next_batch()
        assert bx.shape == (16, 5)
        assert by.shape == (16, 1)
        seen.extend(int(v) for v in by[:, 0])
    # one epoch = exactly one visit per sample, in shuffled order
    assert sorted(seen) == list(range(64))
    assert seen != list(range(64)), "batches were not shuffled"
    np.testing.assert_array_equal(bx[0], x[int(by[0, 0])])
    loader.close()


def test_deterministic_given_seed():
    x, y = _dataset()
    a = PrefetchLoader(x, y, batch_size=8, seed=123)
    b = PrefetchLoader(x, y, batch_size=8, seed=123)
    for _ in range(10):
        xa, ya = a.next_batch()
        xb, yb = b.next_batch()
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    a.close()
    b.close()


def test_epochs_reshuffle():
    x, y = _dataset(n=32)
    loader = PrefetchLoader(x, y, batch_size=8, seed=1)
    e1 = [int(v) for _ in range(4) for v in loader.next_batch()[1][:, 0]]
    e2 = [int(v) for _ in range(4) for v in loader.next_batch()[1][:, 0]]
    assert sorted(e1) == sorted(e2) == list(range(32))
    assert e1 != e2, "epoch 2 must be reshuffled"
    loader.close()


def test_invalid_config_raises():
    x, y = _dataset(n=8)
    with pytest.raises(ValueError):
        PrefetchLoader(x, y, batch_size=16)  # batch > n
    with pytest.raises(ValueError):
        PrefetchLoader(x, y[:4], batch_size=2)  # row mismatch


def test_labels_as_int():
    x, y = _dataset(n=16)
    loader = PrefetchLoader(x, y, batch_size=4, seed=0, labels_as_int=True)
    _, by = loader.next_batch()
    assert by.dtype == np.int32
    loader.close()


def test_native_int_labels_no_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 3)).astype(np.float32)
    y = np.arange(32, dtype=np.int64)
    loader = PrefetchLoader(x, y, batch_size=8, seed=5)
    seen = []
    for _ in range(loader.batches_per_epoch):
        bx, by = loader.next_batch()
        assert by.dtype == np.int64 and bx.dtype == np.float32
        seen.extend(int(v) for v in by)
        np.testing.assert_array_equal(bx[0], x[int(by[0])])
    assert sorted(seen) == list(range(32))
    loader.close()


def test_mmap_backed_dataset(tmp_path):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((48, 6)).astype(np.float32)
    y = np.arange(48, dtype=np.int32)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, x)
    np.save(yp, y)

    loader = PrefetchLoader.from_npy(xp, yp, batch_size=12, seed=4)
    src = loader._inputs
    assert isinstance(src, np.memmap) or isinstance(src.base, np.memmap)
    seen = []
    for _ in range(loader.batches_per_epoch):
        bx, by = loader.next_batch()
        seen.extend(int(v) for v in by)
        np.testing.assert_array_equal(bx[0], x[int(by[0])])
    assert sorted(seen) == list(range(48))
    loader.close()


def test_many_threads_epoch_coverage():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((128, 4)).astype(np.float32)
    y = np.arange(128, dtype=np.int32)
    loader = PrefetchLoader(x, y, batch_size=16, seed=3, depth=6,
                            num_threads=4)
    for _ in range(3):  # three epochs
        seen = []
        for _ in range(loader.batches_per_epoch):
            _, by = loader.next_batch()
            seen.extend(int(v) for v in by)
        assert sorted(seen) == list(range(128))
    loader.close()


def test_prefetch_loader_stop_then_close():
    x, y = _dataset(16, 3)
    loader = PrefetchLoader(x, y, batch_size=4, depth=2)
    xb, _ = loader.next_batch()
    assert xb.shape == (4, 3)
    loader.stop()
    with pytest.raises(RuntimeError, match="shutting down"):
        loader.next_batch()
    assert loader._h is not None  # stop does not free
    loader.close()
    assert loader._h is None


@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_bitwise_equal_to_the_jax_loader(drop_last):
    """Both loaders are built from the same C++ source (the port's copy):
    the same seed gives the same batches, byte for byte, over epochs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((100, 3, 4)).astype(np.float32)
    y = rng.integers(0, 10, 100).astype(np.int64)
    kw = dict(batch_size=16, seed=11, depth=3, num_threads=3,
              drop_last=drop_last)
    port, ref = PrefetchLoader(x, y, **kw), JLoader(x, y, **kw)
    assert port.batches_per_epoch == ref.batches_per_epoch
    for _ in range(3 * port.batches_per_epoch):
        (px, py), (rx, ry) = port.next_batch(), ref.next_batch()
        assert px.tobytes() == rx.tobytes() and py.tobytes() == ry.tobytes()
        assert py.dtype == ry.dtype == np.int64
    port.close()
    ref.close()


def test_device_prefetcher():
    """Batches arrive as tensors on the device with the loader's values,
    and the stream stops after ``n_batches``."""
    x, y = _dataset(n=32)
    loader = PrefetchLoader(x, y, batch_size=8, seed=9)
    ref = PrefetchLoader(x, y, batch_size=8, seed=9)

    with _cpu(loader, depth=2, n_batches=6) as pf:
        batches = list(pf)
    assert len(batches) == 6
    for bx, by in batches:
        assert isinstance(bx, torch.Tensor) and isinstance(by, torch.Tensor)
        assert bx.device.type == "cpu"
        rx, ry = ref.next_batch()
        np.testing.assert_array_equal(bx.numpy(), rx)
        np.testing.assert_array_equal(by.numpy(), ry)
    loader.close()
    ref.close()


def test_device_prefetcher_refuses_what_is_not_ported_or_absent():
    with pytest.raises(TypeError, match="Sharding"):
        DevicePrefetcher(iter([]), device="cpu", sharding=object())
    with pytest.raises(ValueError):
        DevicePrefetcher(iter([]), depth=0, device="cpu")
    if not torch.cuda.is_available():
        # the default is the card; without one it raises, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetcher(iter([]))


def test_device_prefetcher_stopiteration_repeats():
    x, y = _dataset(n=16)
    loader = PrefetchLoader(x, y, batch_size=8, seed=1)
    pf = _cpu(loader, n_batches=2)
    assert len(list(pf)) == 2
    for _ in range(3):
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()
    loader.close()


def test_device_prefetcher_error_propagates():
    def bad_source():
        yield (np.zeros((2, 2)), np.zeros((2,)))
        raise RuntimeError("boom")

    pf = _cpu(bad_source(), depth=2)
    with pytest.raises(RuntimeError, match="boom"):
        for _ in pf:
            pass
    # sticky: re-raised on every later __next__ and readable via .error
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    assert isinstance(pf.error, RuntimeError)
    pf.close()
    assert isinstance(pf.error, RuntimeError)

    def tb_len():
        try:
            next(pf)
        except RuntimeError as e:
            return len(traceback.extract_tb(e.__traceback__))

    first = tb_len()
    for _ in range(5):
        last = tb_len()
    assert last == first  # repeated polls do not grow the traceback


def test_device_prefetcher_delivers_batches_before_the_error():
    def source():
        for i in range(3):
            yield (np.full((2, 2), i, np.float32),)
        raise OSError("disk gone")

    pf = _cpu(source(), depth=4)
    pf._thread.join(timeout=5)  # the worker has queued all and the error
    assert not pf._thread.is_alive()
    got = [float(next(pf)[0][0, 0]) for _ in range(3)]
    assert got == [0.0, 1.0, 2.0]
    with pytest.raises(OSError, match="disk gone"):
        next(pf)
    pf.close()


def test_device_prefetcher_genuine_error_racing_close_is_recorded():
    release = threading.Event()

    def source():
        yield (np.zeros((2, 2)), np.zeros((2,)))
        release.wait(10)
        raise OSError("disk corruption")

    pf = _cpu(source(), depth=1)
    next(pf)  # the worker is now blocked inside the second source read
    threading.Timer(0.5, release.set).start()
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert isinstance(pf.error, OSError)


def test_device_prefetcher_shutdown_sentinel_racing_close_is_clean():
    release = threading.Event()

    def source():
        yield (np.zeros((2, 2)), np.zeros((2,)))
        release.wait(10)
        raise RuntimeError("PrefetchLoader is shutting down")

    pf = _cpu(source(), depth=1)
    next(pf)
    threading.Timer(0.5, release.set).start()
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert pf.error is None


def test_device_prefetcher_close_skips_source_close_when_worker_stuck():
    release = threading.Event()
    closed = []

    class BlockingSource:
        def __iter__(self):
            return self

        def __next__(self):
            release.wait()  # a blocked native next_batch call
            raise StopIteration

        def close(self):
            closed.append(True)

    pf = _cpu(BlockingSource(), depth=1, close_source=True)
    real_join = pf._thread.join
    pf._thread.join = lambda timeout=None: real_join(timeout=0.2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pf.close()
    assert closed == []  # source.close() was NOT called
    assert any("skipping source.close" in str(x.message) for x in w)
    release.set()
    pf._thread.join = real_join
    pf._thread.join(timeout=2.0)
    assert not pf._thread.is_alive()


def test_device_prefetcher_stop_hook_unblocks_worker_then_closes_source():
    release = threading.Event()
    closed, stopped = [], []

    class StoppableBlockingSource:
        def __iter__(self):
            return self

        def __next__(self):
            release.wait()
            raise RuntimeError("PrefetchLoader is shutting down")

        def stop(self):
            stopped.append(True)
            release.set()

        def close(self):
            closed.append(True)

    pf = _cpu(StoppableBlockingSource(), depth=1, close_source=True)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pf.close()
    assert stopped == [True] and closed == [True]
    assert not any(isinstance(x.message, RuntimeWarning) for x in w)
    assert pf.error is None


def test_device_prefetcher_over_loader_closes_native_handle():
    x, y = _dataset(64, 5)
    loader = PrefetchLoader(x, y, batch_size=8, depth=2)
    pf = _cpu(loader, depth=2, close_source=True)
    next(pf)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pf.close()
    assert loader._h is None
    assert not any(isinstance(x.message, RuntimeWarning) for x in w)
    assert not pf._thread.is_alive()


def test_npy_to_prefetcher_to_hf_step_matches_jax(tmp_path):
    """The path the examples' ``--data`` flag wires up -- mmap ``.npy`` ->
    loader -> prefetcher -> HF step -- in both packages from one seed, in
    f64: the same batches and the same step losses (rtol 1e-9)."""
    rng = np.random.default_rng(0)
    xp, yp = str(tmp_path / "train_x.npy"), str(tmp_path / "train_y.npy")
    np.save(xp, rng.standard_normal((64, 7)))
    np.save(yp, rng.standard_normal((64, 3)))

    jparams = j_init_mlp(jax.random.PRNGKey(0), dtype=jnp.float64)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    config = dict(damping=0.5, cg_max_iter=5)

    j_cfg = jhf.HFConfig(**config)
    j_ravel = jhf.TrainableRavel(jparams)
    j_step = jhf.make_hf_step(
        jhf.HFModelFns(model_fn=j_mlp_apply, loss_outer=j_mse), j_cfg,
        j_ravel,
    )
    j_state = jhf.init_state(j_ravel, j_cfg)
    j_losses = []
    with JPrefetcher(JLoader.from_npy(xp, yp, batch_size=16, seed=1),
                     depth=2, n_batches=3, close_source=True) as pf:
        for batch in pf:
            jparams, j_state, stats = j_step(jparams, j_state, batch)
            j_losses.append((float(stats.init_loss), float(stats.final_loss)))

    t_cfg = thf.HFConfig(**config)
    t_ravel = thf.TrainableRavel(tparams)
    t_step = thf.make_hf_step(
        thf.HFModelFns(model_fn=mlp_apply, loss_outer=mse_loss), t_cfg,
        t_ravel,
    )
    t_state = thf.init_state(t_ravel, t_cfg)
    t_losses = []
    loader = PrefetchLoader.from_npy(xp, yp, batch_size=16, seed=1)
    with _cpu(loader, depth=2, n_batches=3, close_source=True) as pf:
        for batch in pf:
            x, y = batch
            assert isinstance(x, torch.Tensor) and x.dtype == torch.float64
            assert x.shape == (16, 7) and y.shape == (16, 3)
            tparams, t_state, stats = t_step(tparams, t_state, batch)
            t_losses.append((float(stats.init_loss), float(stats.final_loss)))
    assert loader._h is None
    assert len(t_losses) == 3 and int(t_state.step_count) == 3
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-9)


def test_runtime_has_no_cuda_path_without_a_card():
    """On the CPU the prefetcher keeps no stream and records no event: a
    batch is ``torch.from_numpy`` of the loader's arrays."""
    arr = np.arange(6, dtype=np.int64).reshape(2, 3)
    pf = _cpu(iter([(arr, {"a": arr})]), n_batches=1)
    x, d = next(pf)
    assert pf._stream is None
    assert x.dtype == torch.int64 and torch.equal(x, d["a"])
    np.testing.assert_array_equal(x.numpy(), arr)
    pf.close()
