"""The port's sampling primitives (``deepspeed_tpu_torch/ops/sampling.py``)
and ``generate``'s token picker against the JAX package's
(``deepspeed_tpu/ops/sampling.py``, ``inference/engine.py::
_make_token_picker``) on the CPU, inputs from numpy seeds.

Keys, raw bits and uniforms are JAX's threefry bit for bit.  Gumbel noise
is ``-log(-log(u))`` of identical ``u``: PyTorch's and XLA's ``log`` may
differ in the last ulp, so the inner log is held within 2 ulp and the
noise within what that becomes through the outer log, and a categorical draw
equal to JAX's on every row whose two best perturbed scores differ by more
than 1e-5 (rows closer than that are counted and must be rare).
``filtered_logprobs`` agrees within 1e-6 with equal keep-sets on logits
whose top-p boundary is not within 1e-6: XLA's and PyTorch's ``cumsum``
may round differently, which can move a token that sits on the boundary.
The total-variation cases of ``tests/unit/test_sampling.py`` run on the
port's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import engine as jengine
from deepspeed_tpu.ops import sampling as J
from deepspeed_tpu_torch.inference import engine as tengine
from deepspeed_tpu_torch.ops import sampling as T

# one intra-op thread: the suite runs as pytest-xdist workers that share
# the machine's cores, and a torch pool of every core in each worker
# left them oversubscribed (ROADMAP.md "Time budget")
torch.set_num_threads(1)

SEEDS = np.array([0, 1, 7, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 123456789,
                  4000000000], np.uint64).astype(np.uint32)
COUNTS = np.array([0, 1, 3, 999, 65536, 10 ** 6 - 1, 10 ** 6, 77], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _ulps(a, b):
    """|a - b| in float32 ulps (same-sign finite values)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


# ----------------------------------------------------------------- keys
@pytest.mark.parametrize("salt", [T.SALT_TOKEN, T.SALT_ACCEPT,
                                  T.SALT_RESIDUAL, T.SALT_DRAFT])
def test_slot_keys_bit_exact(salt):
    want = np.asarray(J.slot_keys(SEEDS, COUNTS, salt)).astype(np.int64)
    got = T.slot_keys(_t(SEEDS), torch.from_numpy(COUNTS), salt).numpy()
    np.testing.assert_array_equal(got, want)
    # an int32 bit pattern of the seed gives the same keys
    got32 = T.slot_keys(torch.from_numpy(SEEDS.view(np.int32)),
                        torch.from_numpy(COUNTS), salt).numpy()
    np.testing.assert_array_equal(got32, want)


@pytest.mark.parametrize("width", [1, 4])
def test_grid_keys_bit_exact(width):
    want = np.asarray(J.grid_keys(SEEDS, COUNTS, J.SALT_TOKEN, width))
    got = T.grid_keys(_t(SEEDS), torch.from_numpy(COUNTS), T.SALT_TOKEN,
                      width).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    for i in range(width):        # position i is the slot key at count + i
        np.testing.assert_array_equal(
            got[:, i], T.slot_keys(_t(SEEDS), torch.from_numpy(COUNTS + i),
                                   T.SALT_TOKEN).numpy())


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
def test_prngkey_and_fold_in_bit_exact(seed):
    key = jax.random.PRNGKey(np.uint32(seed))
    np.testing.assert_array_equal(T.PRNGKey(seed).numpy(),
                                  np.asarray(key).astype(np.int64))
    for data in (0, 5, 10 ** 6, 2 ** 31 + 3):
        want = np.asarray(jax.random.fold_in(key, np.uint32(data)))
        np.testing.assert_array_equal(
            T.fold_in(T.PRNGKey(seed), data).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", [-1, -7, 2 ** 31 + 1, 2 ** 32 - 1,
                                  2 ** 32 + 5, 2 ** 40 + 7, 0])
def test_prngkey_maps_seeds_as_jax_x32_does(seed):
    """Python-int seeds outside [0, 2**32) too: JAX's default 32-bit mode
    takes the seed as an int32, so the high word is 0."""
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(T.PRNGKey(seed).numpy(),
                                  want.astype(np.int64))
    np.testing.assert_array_equal(
        T.fold_in(T.PRNGKey(seed), 7).numpy(),
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), 7))
        .astype(np.int64))


# -------------------------------------------------- bits, uniform, gumbel
SHAPES = [(513,), (3, 257)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits_and_uniform_bit_exact(shape):
    key = jax.random.PRNGKey(1234)
    tkey = T.PRNGKey(1234)
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32))
    np.testing.assert_array_equal(T.random_bits(tkey, shape).numpy(),
                                  bits.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (-2.0, 3.5)):
        want = np.asarray(jax.random.uniform(key, shape, minval=lo,
                                             maxval=hi))
        np.testing.assert_array_equal(
            T.uniform(tkey, shape, lo, hi).numpy(), want)


def test_per_row_keys_give_each_rows_draw():
    """A ``[R, 2]`` stack of keys draws row ``r`` as key ``r`` alone."""
    keys = T.slot_keys(_t(SEEDS[:4]), torch.from_numpy(COUNTS[:4]), 1)
    got = T.uniform(keys, (65,)).numpy()
    jkeys = J.slot_keys(SEEDS[:4], COUNTS[:4], 1)
    for r in range(4):
        np.testing.assert_array_equal(
            got[r], np.asarray(jax.random.uniform(jkeys[r], (65,))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_two_ulp(shape):
    """``g = -log(t)``, ``t = -log(u)`` on bit-identical ``u``: ``t``
    within 2 ulp of JAX's, and ``g`` within what 2 ulp of ``t`` become
    through the outer log (a relative 2**-22 of ``t``, i.e. 2.4e-7
    absolute in ``g``) plus 2 ulp of its own."""
    tiny = float(np.finfo(np.float32).tiny)
    ju = jax.random.uniform(jax.random.PRNGKey(99), shape, minval=tiny)
    jt = np.asarray(-jnp.log(ju))
    tt = -torch.log(T.uniform(T.PRNGKey(99), shape, tiny, 1.0)).numpy()
    assert (tt > 0).all() and _ulps(tt, jt).max() <= 2
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(99), shape))
    got = T.gumbel(T.PRNGKey(99), shape).numpy()
    assert np.isfinite(got).all()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got - want) <= 2.0 ** -22 + 2 * ulp).all()


# ---------------------------------------------------- filtered_logprobs
def _knobs(rows, rng):
    temps = rng.choice([0.0, 0.5, 0.8, 1.0, 1.3], rows).astype(np.float32)
    topks = rng.choice([0, 1, 5, 40, 200], rows).astype(np.int32)
    topps = rng.choice([1.0, 0.9, 0.5, 0.95], rows).astype(np.float32)
    return temps, topks, topps


def _boundary_margins(logits, temps, topks, topps):
    """Per row, the smallest distance (float64) between top_p and the
    exclusive cumulative probability of a kept top-k token — how near
    the nucleus boundary sits to a token."""
    out = []
    for row, t, k, p in zip(logits.astype(np.float64), temps, topks, topps):
        x = row / max(t, 1e-6)
        srt = np.sort(x)[::-1]
        keep = x >= srt[(k if k > 0 else x.size) - 1]
        e = np.exp(x[keep] - x[keep].max())
        psort = np.sort(e / e.sum())[::-1]
        out.append(np.abs(np.cumsum(psort) - psort - p).min())
    return np.asarray(out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filtered_logprobs_matches_jax(seed):
    """Within 1e-6 wherever both keep a token; the same keep-sets on every
    row whose nucleus boundary is not within 1e-6 of a token (most rows:
    a top_p = 1 row over a long tail is the usual exception)."""
    rng = np.random.default_rng(seed)
    rows, vocab = 16, 512
    logits = (rng.standard_normal((rows, vocab)) * 3).astype(np.float32)
    temps, topks, topps = _knobs(rows, rng)
    clear = _boundary_margins(logits, temps, topks, topps) > 1e-6
    clear |= temps == 0                              # one-hot rows
    assert clear.sum() >= rows // 2, clear
    jg, jlp = J.filtered_logprobs(jnp.asarray(logits), temps, topks, topps)
    tg, tlp = T.filtered_logprobs(torch.from_numpy(logits),
                                  torch.from_numpy(temps),
                                  torch.from_numpy(topks),
                                  torch.from_numpy(topps))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    jlp, tlp = np.asarray(jlp), tlp.numpy()
    np.testing.assert_array_equal(np.isfinite(tlp[clear]),
                                  np.isfinite(jlp[clear]))
    both = np.isfinite(jlp) & np.isfinite(tlp)
    assert both[clear].sum() == np.isfinite(jlp[clear]).sum()
    np.testing.assert_allclose(tlp[both], jlp[both], rtol=0, atol=1e-6)
    # greedy rows are the exact one-hot at the argmax
    for r in np.flatnonzero(temps == 0):
        assert tlp[r, tg[r]] == 0.0
        assert np.isneginf(np.delete(tlp[r], int(tg[r]))).all()


def test_filtered_logprobs_unit_cases():
    """``test_sampling.py``'s top-k ties and nucleus boundary."""
    lp = T.filtered_logprobs(torch.tensor([[4.0, 3.0, 3.0, 1.0, 0.0]]),
                             torch.ones(1), torch.tensor([2]),
                             torch.ones(1))[1].numpy()[0]
    assert np.isfinite(lp[[0, 1, 2]]).all() and np.isneginf(lp[[3, 4]]).all()
    assert np.isclose(np.exp(lp[np.isfinite(lp)]).sum(), 1.0, atol=1e-6)
    probs = np.array([0.5, 0.3, 0.15, 0.05], np.float32)
    for p, want in ((0.7, [0, 1]), (0.85, [0, 1, 2]), (1.0, [0, 1, 2, 3])):
        _, lp = T.filtered_logprobs(torch.from_numpy(np.log(probs)[None]),
                                    torch.ones(1), torch.zeros(1, dtype=torch.int32),
                                    torch.tensor([p]))
        assert np.flatnonzero(np.isfinite(lp.numpy()[0])).tolist() == want
    masks = torch.zeros((2, 9), dtype=torch.bool)
    masks[0, [2, 5]] = True
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 9)).astype(np.float32))
    greedy, _ = T.filtered_logprobs(logits, torch.zeros(2),
                                    torch.zeros(2, dtype=torch.int32),
                                    torch.ones(2), masks)
    assert int(greedy[0]) in (2, 5)
    assert int(greedy[1]) == int(logits[1].argmax())


# -------------------------------------------------------- sample_tokens
def test_sample_tokens_matches_jax_off_near_ties():
    rng = np.random.default_rng(7)
    rows, vocab = 512, 300
    logits = (rng.standard_normal((rows, vocab)) * 2).astype(np.float32)
    temps = np.full(rows, 0.9, np.float32)
    topks = np.zeros(rows, np.int32)
    topps = np.ones(rows, np.float32)
    _, jlp = J.filtered_logprobs(jnp.asarray(logits), temps, topks, topps)
    lp = np.asarray(jlp)
    seeds = rng.integers(0, 2 ** 32, rows, dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 10 ** 6, rows).astype(np.int32)
    jkeys = J.slot_keys(seeds, counts, J.SALT_TOKEN)
    want = np.asarray(J.sample_tokens(jnp.asarray(lp), jkeys))
    tkeys = T.slot_keys(_t(seeds), torch.from_numpy(counts), T.SALT_TOKEN)
    got = T.sample_tokens(torch.from_numpy(lp.copy()), tkeys).numpy()
    # the perturbed scores JAX raced, to find rows decided within 1e-5
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (vocab,)))(jkeys))
    top2 = np.sort(g + lp, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= 1e-5
    assert near.sum() <= rows // 100, near.sum()
    np.testing.assert_array_equal(got[~near], want[~near])


def test_temperature_zero_rows_draw_the_argmax():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    greedy, lp = T.filtered_logprobs(logits, torch.zeros(6),
                                     torch.zeros(6, dtype=torch.int32),
                                     torch.ones(6))
    keys = T.slot_keys(torch.arange(6), torch.arange(6), T.SALT_TOKEN)
    np.testing.assert_array_equal(T.sample_tokens(lp, keys).numpy(),
                                  logits.argmax(-1).numpy())
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1).numpy())


def test_accept_uniforms_token_probs_residual_logits_match_jax():
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    counts = np.arange(64, dtype=np.int32)
    jk = J.grid_keys(seeds, counts, J.SALT_ACCEPT, 3)
    tk = T.grid_keys(_t(seeds), torch.from_numpy(counts), T.SALT_ACCEPT, 3)
    np.testing.assert_array_equal(T.accept_uniforms(tk).numpy(),
                                  np.asarray(J.accept_uniforms(jk)))
    lp = np.log(rng.dirichlet(np.ones(9), 64)).astype(np.float32)
    lp[0] = [0.0] + [-np.inf] * 8                    # a one-hot row
    tokens = rng.integers(0, 9, 64).astype(np.int32)
    tokens[0] = 0                                   # its draft IS the argmax
    np.testing.assert_allclose(
        T.token_probs(torch.from_numpy(lp), torch.from_numpy(tokens)).numpy(),
        np.asarray(J.token_probs(jnp.asarray(lp), jnp.asarray(tokens))),
        rtol=1e-6)
    np.testing.assert_array_equal(
        T.residual_logits(torch.from_numpy(lp),
                          torch.from_numpy(tokens)).numpy(),
        np.asarray(J.residual_logits(jnp.asarray(lp), jnp.asarray(tokens))))


# ------------------------------------------- distributions (TV < 0.05)
def _tv(counts, probs):
    freq = counts / counts.sum()
    return 0.5 * np.abs(freq - probs).sum()


def test_categorical_draws_match_distribution():
    probs = np.array([0.45, 0.25, 0.15, 0.1, 0.05], np.float32)
    n = 4000
    lp = torch.from_numpy(np.tile(np.log(probs), (n, 1)))
    keys = T.slot_keys(torch.full((n,), 7), torch.arange(n), T.SALT_TOKEN)
    draws = T.sample_tokens(lp, keys).numpy()
    counts = np.bincount(draws, minlength=5).astype(float)
    assert _tv(counts, probs) < 0.05, counts


def test_delta_rejection_marginal_is_target_distribution():
    probs = np.array([0.4, 0.3, 0.2, 0.1], np.float32)
    d, n = 3, 4000
    lp = torch.from_numpy(np.tile(np.log(probs), (n, 1)))
    drafts = torch.full((n,), d, dtype=torch.int32)
    seeds, counts = torch.full((n,), 11), torch.arange(n)
    u = T.accept_uniforms(T.slot_keys(seeds, counts, T.SALT_ACCEPT)).numpy()
    accept = u < T.token_probs(lp, drafts).numpy()
    resid = T.sample_tokens(T.residual_logits(lp, drafts),
                            T.slot_keys(seeds, counts, T.SALT_RESIDUAL))
    resid = resid.numpy()
    final = np.where(accept, d, resid)
    assert not np.any(resid[~accept] == d)
    assert _tv(np.bincount(final, minlength=4).astype(float), probs) < 0.05
    assert abs(accept.mean() - probs[d]) < 0.03


# ----------------------------------------------- generate's token picker
PICKERS = [(1.0, 0, 1.0), (0.7, 0, 1.0), (0.8, 50, 1.0), (1.0, 0, 0.9),
           (0.8, 20, 0.9), (1.2, 3, 0.5)]


@pytest.mark.parametrize("temperature,top_k,top_p", PICKERS,
                         ids=[f"t{t}-k{k}-p{p}" for t, k, p in PICKERS])
def test_generate_picker_matches_make_token_picker(temperature, top_k, top_p):
    """``generate(do_sample=True, seed=s)``'s picker on fixed logits: the
    JAX picker's key ``fold_in(PRNGKey(s), position)`` over the whole
    ``[B, V]`` draw, the same draws off near-ties."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    b, vocab, seed = 64, 257, 5
    logits = (rng.standard_normal((b, vocab)) * 2).astype(np.float32)
    cfg = (True, temperature, top_k, top_p)
    rng_j = jax.random.PRNGKey(seed)
    tpick = tengine._make_token_picker(cfg)
    jpick = jengine._make_token_picker(cfg)
    near_total = 0
    for pos in (7, 8, 300):
        want = np.asarray(jpick(jnp.asarray(logits),
                                jax.random.fold_in(rng_j, pos)))
        got = tpick(torch.from_numpy(logits), T.PRNGKey(seed), pos).numpy()
        # the perturbed scores of the JAX draw, to find near-ties
        x = logits / max(temperature, 1e-6)
        g = np.asarray(jax.random.gumbel(jax.random.fold_in(rng_j, pos),
                                         (b, vocab)))
        top2 = np.sort(g + x, axis=-1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) <= 1e-5
        near_total += int(near.sum())
        np.testing.assert_array_equal(got[~near], want[~near])
    assert near_total <= 2
