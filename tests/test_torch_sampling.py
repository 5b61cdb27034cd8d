"""Top-k sampling of the port (``repro_torch.serving.engine.sample_topk``)
against the JAX package's, on the CPU.

jax.random's bits cannot be reproduced, so the two samplers are held to the
same distribution: on fixed numpy-seeded logits [4, 512], N = 4,000 draws a
row from each (JAX's ``sample_topk`` over ``jax.random.split`` keys, the
port's over keys 0..N-1) go through a chi-square test against the exact
top-k softmax probabilities; each test must give p >= 1e-3 (bins with an
expected count below 5 pooled).  With k = 1 both samplers are the argmax.
The port's draw is a pure function of (key, step, row, token): its hash is
held to a plain-integer reference, and a CPU engine's tokens to the
sampler applied at step 0 (prefill) and 1 (first decode step).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serving.engine import sample_topk as jax_sample_topk
from repro_torch.configs import get_smoke_config
from repro_torch.serving import ServeConfig, ServingEngine, sample_topk
from repro_torch.serving.engine import uniform_bits

N = 4000
ROWS, VOCAB, TEMPERATURE = 4, 512, 0.8
P_MIN = 1e-3  # the smallest chi-square p-value a sampler may give


def _logits() -> np.ndarray:
    return (np.random.default_rng(0).standard_normal((ROWS, VOCAB)) * 2.0).astype(np.float32)


def _exact(row: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """The top-k token ids of ``row`` and their softmax(v / T), float64."""
    idx = np.argsort(-row, kind="stable")[:k]
    v = row[idx].astype(np.float64) / TEMPERATURE
    p = np.exp(v - v.max())
    return idx, p / p.sum()


def _chi2_p(draws: np.ndarray, idx: np.ndarray, probs: np.ndarray) -> float:
    """p-value of the draws' counts over ``idx`` against ``probs``, tokens
    expected fewer than 5 times pooled into one bin."""
    counts = np.array([(draws == t).sum() for t in idx], np.float64)
    expected = probs * len(draws)
    small = expected < 5
    if small.any():
        counts = np.append(counts[~small], counts[small].sum())
        expected = np.append(expected[~small], expected[small].sum())
    return float(stats.chisquare(counts, expected).pvalue)


def _jax_draws(logits: np.ndarray, k: int) -> np.ndarray:
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    draw = jax.jit(jax.vmap(lambda key: jax_sample_topk(key, jnp.asarray(logits), k,
                                                        TEMPERATURE)))
    return np.asarray(draw(keys))  # [N, ROWS]


def _port_draws(logits: np.ndarray, k: int) -> np.ndarray:
    keys = torch.arange(N).reshape(N, 1, 1)
    batch = torch.as_tensor(logits).expand(N, ROWS, VOCAB)
    return sample_topk(keys, batch, k=k, temperature=TEMPERATURE).numpy()  # [N, ROWS]


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("k", [5, 40])
def test_topk_draws_follow_the_exact_probabilities(side, k):
    logits = _logits()
    draws = (_jax_draws if side == "jax" else _port_draws)(logits, k)
    assert draws.shape == (N, ROWS)
    for r in range(ROWS):
        idx, probs = _exact(logits[r], k)
        assert np.isin(draws[:, r], idx).all(), f"row {r}: a draw outside the top {k}"
        p = _chi2_p(draws[:, r], idx, probs)
        assert p >= P_MIN, (side, k, r, p)


def test_topk_with_k_one_is_the_argmax_on_both_sides():
    logits = _logits()
    want = logits.argmax(-1)
    for draws in (_jax_draws(logits, 1), _port_draws(logits, 1)):
        assert (draws == want[None]).all()


def _mix32_ref(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_uniform_bits_is_the_plain_integer_hash():
    """Every product stays inside int64, negative keys included: the draw
    is lowbias32 folded over the five words as unsigned 32-bit integers."""
    rng = np.random.default_rng(3)
    keys = [int(k) for k in rng.integers(-2 ** 63, 2 ** 63 - 1, 6, dtype=np.int64)] + [0, -1]
    for key in keys:
        step, row, token = (int(v) for v in rng.integers(0, 2 ** 20, 3))
        h = _mix32_ref(key ^ 0x9E3779B9)
        for word in (key >> 32, step, row, token):
            h = _mix32_ref(h ^ (word & 0xFFFFFFFF))
        got = uniform_bits(*(torch.tensor(v) for v in (key, step, row, token)))
        assert got.item() == (h + 0.5) / 2 ** 32


def test_draw_is_the_gumbel_argmax_over_the_top_k_in_any_order():
    """The draw is argmax of v / T + g over the top-k set, each candidate's
    g keyed by its token id: taken in token-id order, not ``torch.topk``'s,
    the set gives the same draw (tied logits cannot reorder it)."""
    logits = torch.as_tensor(_logits())
    for key in range(20):
        got = sample_topk(key, logits, k=40)
        for r in range(ROWS):
            ids = torch.sort(torch.topk(logits[r], 40).indices).values
            u = uniform_bits(torch.tensor(key), torch.tensor(0), torch.tensor(r), ids)
            score = logits[r, ids].double() / TEMPERATURE - torch.log(-torch.log(u))
            assert got[r].item() == ids[score.argmax()].item()


def _topk_engine():
    return ServingEngine(get_smoke_config("qwen3-0.6b"),
                         ServeConfig(max_context=32, batch=2, sampler="topk"), device="cpu")


def test_engine_keys_decide_the_tokens():
    """One key gives one job's tokens, on one engine or a fresh one; other
    keys give others; a generator draws a key; key and generator refuse
    each other."""
    eng = _topk_engine()
    prompts = np.random.default_rng(5).integers(0, eng.cfg.vocab, (2, 8)).astype(np.int32)
    first = eng.generate(prompts, 8, key=11)[0]
    np.testing.assert_array_equal(eng.generate(prompts, 8, key=11)[0], first)
    np.testing.assert_array_equal(_topk_engine().generate(prompts, 8, key=11)[0], first)
    others = [eng.generate(prompts, 8, key=k)[0] for k in (12, -11, 2 ** 40)]
    assert all(not np.array_equal(o, first) for o in others)
    drawn = [eng.generate(prompts, 8, generator=torch.Generator().manual_seed(s))[0]
             for s in (0, 0, 1)]
    np.testing.assert_array_equal(drawn[0], drawn[1])
    assert not np.array_equal(drawn[0], drawn[2])
    np.testing.assert_array_equal(eng.generate(prompts, 8)[0], eng.generate(prompts, 8, key=0)[0])
    with pytest.raises(ValueError, match="not both"):
        eng.generate(prompts, 8, generator=torch.Generator(), key=1)


def test_engine_samples_the_prefill_at_step_zero_and_each_decode_step_at_the_next():
    """As JAX's ``generate`` uses its key for the first token and splits it
    once a decode step: the engine's first two tokens are ``sample_topk``
    of the prefill's and the first decode step's logits at steps 0 and 1."""
    eng = _topk_engine()
    prompts = np.random.default_rng(6).integers(0, eng.cfg.vocab, (2, 8)).astype(np.int32)
    out = eng.generate(prompts, 2, key=99)[0]
    model = eng.model
    with torch.inference_mode():
        caches = model.init_caches(2, 32)
        logits, caches = model.prefill(torch.as_tensor(prompts), caches)
        first = sample_topk(99, logits[:, -1], step=0)
        logits, _ = model.decode_step(first[:, None], caches, torch.full((2,), 8))
        second = sample_topk(99, logits[:, -1], step=1)
    np.testing.assert_array_equal(out[:, 0], first.numpy())
    np.testing.assert_array_equal(out[:, 1], second.numpy())
