"""The port's host C++ (``deepspeed_tpu_torch/ops/cpu_adam.py`` over
``ops/csrc/cpu_adam.cpp``, ``ops/aio.py`` over ``ops/csrc/aio.cpp``,
built with g++ by ``op_builder.HostOpBuilder``) against the JAX package's
libraries on the same numpy buffers.

The two Adam/Adagrad libraries run the same loop with the same g++ flags,
so they must agree bit for bit; the plain PyTorch versions follow the
compiled loop's roundings (its FMAs, a correctly rounded sqrt) and are held
within rtol 1e-6 (they agree bit for bit on this host).  ``ds_sq_norm``
sums in an order that depends on the thread count: held within 1e-12
relative.  Both libraries share one OpenMP runtime, capped at one thread a
test worker here.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import aio as jaio
from deepspeed_tpu.ops import cpu_adam as jadam
from deepspeed_tpu_torch.ops import aio as taio
from deepspeed_tpu_torch.ops import cpu_adam as tadam
from deepspeed_tpu_torch.ops import op_builder

# one torch intra-op thread a pytest-xdist worker
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_openmp_thread():
    """One OpenMP thread a pytest-xdist worker: the host library's pool
    (shared with the JAX package's) is the process's, sized here rather
    than at import so that collecting the file builds nothing."""
    tadam.set_num_threads(1)

N = 20011


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy(
        ).view(np.uint16)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adamw_mode", [True, False])
def test_adam_matches_jax_bit_for_bit(weight_decay, bias_correction,
                                      adamw_mode):
    """5 steps on the same buffers: the port's ``ds_adam_step`` (and its
    bf16-writing entry) equal the JAX library's; the plain version is
    within rtol 1e-6; the bf16 copy is ``Tensor.to(torch.bfloat16)``."""
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
              weight_decay=weight_decay, bias_correction=bias_correction,
              adamw_mode=adamw_mode)
    p = rng.normal(size=N).astype(np.float32)
    state = [p, np.zeros(N, np.float32), np.zeros(N, np.float32)]
    ours = [x.copy() for x in state]
    plain = [torch.from_numpy(x.copy()) for x in state]
    jopt, topt = jadam.DeepSpeedCPUAdam(**kw), tadam.DeepSpeedCPUAdam(**kw)
    assert jopt.has_native
    out16 = np.zeros(N, np.uint16)
    for step in range(1, 6):
        g = rng.normal(size=N).astype(np.float32)
        lr = 1e-2 / step
        jopt.step(state[0], g, state[1], state[2], lr=lr)
        topt.step(ours[0], g, ours[1], ours[2], lr=lr,
                  out16=out16 if step % 2 else None)
        tadam.adam_step_plain(plain[0], torch.from_numpy(g), plain[1],
                              plain[2], step, lr, (0.9, 0.95), 1e-8,
                              weight_decay, bias_correction, adamw_mode)
        for want, got, pl in zip(state, ours, plain):
            np.testing.assert_array_equal(_bits(got), _bits(want))
            np.testing.assert_allclose(pl.numpy(), want, rtol=1e-6)
    assert topt.step_count == jopt.step_count == 5
    # the last bf16-writing step (step 5) wrote the updated weights
    np.testing.assert_array_equal(out16, _bf16_bits(ours[0]))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adagrad_matches_jax_bit_for_bit(weight_decay):
    rng = np.random.default_rng(1)
    p = rng.normal(size=N).astype(np.float32)
    state = [p, np.zeros(N, np.float32)]
    ours = [x.copy() for x in state]
    plain = [torch.from_numpy(x.copy()) for x in state]
    jopt = jadam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=weight_decay)
    topt = tadam.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=weight_decay)
    out16 = np.zeros(N, np.uint16)
    for _ in range(5):
        g = rng.normal(size=N).astype(np.float32)
        jopt.step(state[0], g, state[1])
        topt.step(ours[0], g, ours[1], out16=out16)
        tadam.adagrad_step_plain(plain[0], torch.from_numpy(g), plain[1],
                                 1e-2, weight_decay=weight_decay)
        for want, got, pl in zip(state, ours, plain):
            np.testing.assert_array_equal(_bits(got), _bits(want))
            np.testing.assert_allclose(pl.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(out16, _bf16_bits(ours[0]))


def test_bf16_write_rounds_as_torch():
    """Ties to even, subnormals, +-0, +-inf, the largest finite floats
    (which round to inf) and random values: the bf16-writing
    entries' rounding is ``Tensor.to(torch.bfloat16)``'s."""
    one = np.float32(1.0)
    special = np.array([
        1.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 1.0 + 2 ** -8 + 2 ** -20,
        -(1.0 + 2 ** -8), 2 ** -130, -(2 ** -130), 3e-39, 1e-45, -1e-45,
        0.0, -0.0, np.inf, -np.inf, 3.4028235e38, -3.4028235e38,
        65504.0, 2 ** -126, 1.17549e-38], np.float32)
    rng = np.random.default_rng(2)
    x = np.concatenate([special, rng.normal(size=4096).astype(np.float32),
                        (rng.normal(size=4096) * 1e-39).astype(np.float32),
                        one + np.arange(256, dtype=np.float32) * 2 ** -15])
    # an Adam step that leaves the values as they are (zero gradient and
    # moments, zero lr) writes their bf16 bits
    p, m, v = x.copy(), np.zeros_like(x), np.zeros_like(x)
    out = np.zeros(x.size, np.uint16)
    tadam.DeepSpeedCPUAdam(lr=0.0).step(p, np.zeros_like(x), m, v,
                                        out16=out)
    np.testing.assert_array_equal(p.view(np.uint32), x.view(np.uint32))
    np.testing.assert_array_equal(out, _bf16_bits(x))
    # and so does Adagrad's bf16 entry on the finite ones (0 * inf is NaN)
    x = x[np.isfinite(x)]
    p, s = x.copy(), np.zeros_like(x)
    out2 = np.zeros(x.size, np.uint16)
    tadam.DeepSpeedCPUAdagrad(lr=0.0).step(p, np.zeros_like(x), s,
                                           out16=out2)
    np.testing.assert_array_equal(out2, _bf16_bits(x))


def test_norm_scale_finite_and_add_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=N).astype(np.float32)
    want = jadam.sq_norm(x)
    assert abs(tadam.sq_norm(x) - want) <= 1e-12 * want
    assert abs(tadam.sq_norm_plain(x) - want) <= 1e-12 * want
    a, b = x.copy(), x.copy()
    jadam.scale_(a, 0.37)
    tadam.scale_(b, 0.37)
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert tadam.all_finite(x) and jadam.all_finite(x)
    for bad in (np.inf, -np.inf, np.nan):
        y = x.copy()
        y[N // 2] = bad
        assert not tadam.all_finite(y) and not jadam.all_finite(y)
    acc = x.copy()
    tadam.add_(acc, x)
    np.testing.assert_array_equal(acc, x + x)
    with pytest.raises(ValueError):
        tadam.sq_norm(x.astype(np.float64))
    with pytest.raises(ValueError):
        tadam.scale_(x[::2], 2.0)


def test_thread_count_keeps_elementwise_bits():
    """The elementwise entries give the same bits on 1 and 3 threads; the
    pool size is the caller's to set."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=N).astype(np.float32)
    g = rng.normal(size=N).astype(np.float32)
    runs = []
    try:
        for threads in (1, 3):
            tadam.set_num_threads(threads)
            assert tadam.get_num_threads() == threads
            st = [p.copy(), np.zeros(N, np.float32), np.zeros(N, np.float32)]
            tadam.DeepSpeedCPUAdam(lr=1e-3).step(st[0], g, st[1], st[2])
            runs.append((st, tadam.sq_norm(g)))
    finally:
        tadam.set_num_threads(1)
    for a, b in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert abs(runs[0][1] - runs[1][1]) <= 1e-12 * runs[0][1]


def test_torch_buffers_and_numpy_views_share_the_step():
    """Flat CPU tensors and numpy views of them are the same buffers."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    m, v = torch.zeros(N), torch.zeros(N)
    p2, m2, v2 = p.numpy().copy(), np.zeros(N, np.float32), \
        np.zeros(N, np.float32)
    out16 = torch.empty(N, dtype=torch.bfloat16)
    tadam.DeepSpeedCPUAdam().step(p, g, m, v, out16=out16)
    tadam.DeepSpeedCPUAdam().step(p2, g.numpy(), m2, v2)
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(p2))
    assert torch.equal(out16, p.to(torch.bfloat16))
    with pytest.raises(ValueError):
        tadam.DeepSpeedCPUAdam().step(p, g[:-1], m, v)


def test_failed_build_raises_with_compiler_output(tmp_path):
    """No fallback: a host library that does not compile raises, with
    g++'s message."""
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return missing_symbol; }\n')
    b = op_builder.HostOpBuilder("broken_for_test", [str(src)])
    with pytest.raises(RuntimeError, match="missing_symbol"):
        b.load()
    assert not b.library_path().exists()


# --------------------------------------------------------------------- aio
def test_aio_roundtrip_matches_jax(tmp_path):
    """The port's handle writes what the JAX handle reads back, and the
    reverse, through both engines' backends."""
    rng = np.random.default_rng(6)
    data = rng.normal(size=(4, 1000)).astype(np.float32)
    th, jh = taio.AsyncIOHandle(2), jaio.AsyncIOHandle(2)
    try:
        assert th.backend == jh.backend
        path = str(tmp_path / "swap.bin")
        for i in range(4):
            th.async_pwrite(data[i], path, i * data[i].nbytes)
        assert th.wait() == 0
        back = np.zeros_like(data)
        for i in range(4):
            jh.async_pread(back[i], path, i * data[i].nbytes)
        assert jh.wait() == 0
        np.testing.assert_array_equal(back, data)
        out = torch.zeros(4000)
        th.async_pread(out, path, 0)
        assert th.wait() == 0
        np.testing.assert_array_equal(out.numpy(), data.reshape(-1))
    finally:
        th.close()
        jh.close()


def test_aio_failures_are_reported(tmp_path):
    h = taio.AsyncIOHandle(2)
    try:
        buf = np.zeros(16, np.float32)
        t = h.async_pread(buf, str(tmp_path / "missing.bin"), 0)
        assert h.wait_statuses() == {t: False}
        path = str(tmp_path / "short.bin")
        np.ones(4, np.float32).tofile(path)
        assert taio.swap_chain_read(h, path, [buf], [0]) == [False]
        blocks = [np.full(8, i, np.float32) for i in range(3)]
        assert taio.swap_chain_write(h, path, blocks, [0, 32, 64]) == \
            [True] * 3
        outs = [np.zeros(8, np.float32) for _ in range(3)]
        assert taio.swap_chain_read(h, path, outs, [0, 32, 64]) == [True] * 3
        for a, b in zip(outs, blocks):
            np.testing.assert_array_equal(a, b)
    finally:
        h.close()
    with pytest.raises(RuntimeError):
        h.async_pread(np.zeros(4, np.float32), path, 0)
