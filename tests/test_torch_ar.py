"""The port's v2 AR model (seedvc_tpu_torch/models/ar.py) against the JAX
one (seedvc_tpu/models/ar.py) on the same random weights, tiny and f32.

The full forward, the packed prefill and one decode step agree within 1e-4
(the caches too, the port's (L, B, G, S, hd) layout transposed back), and a
decode step continues a prefill as the full forward does. ``sample_token``
given JAX's exponential draws picks JAX's token for every knob setting. The
batched left-padded ``generate``, fed JAX's draws by replaying its key
schedule (``torch_port_helpers.jax_ar_draws``), emits exactly JAX's tokens
and counts for both penalty scopes with rows that finish at different
steps, and past ``max_seq_len``, where both clamp the kv slot and the RoPE
position.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seedvc_tpu.models import ar as jar
from seedvc_tpu_torch.models import ar as par
from seedvc_tpu_torch.weights import load_jax_params
from torch_port_helpers import jax_ar_draws, jax_init

torch.set_num_threads(1)

JCFG = jar.ARConfig(dim=32, n_layer=2, n_head=4, n_local_heads=2, head_dim=8,
                    intermediate_size=64, vocab_size=33, max_seq_len=128)
TOL = 1e-4


def _pcfg(jcfg):
    return par.ARConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def _pair(jcfg=JCFG, seed=0, eos=None):
    """(JAX model, its params, port model) on the same weights. ``eos``:
    "likely" adds 1.5 to the output layer's EOS column, so rows end sooner;
    "rare" zeroes it and scales the others by 4, so EOS sits mid-range and
    falls outside top-p."""
    jm = jar.ARTransformer(jcfg)
    params = jax_init(jm, jnp.zeros((1, 4), jnp.int32), jnp.arange(4)[None],
                      jnp.tril(jnp.ones((4, 4), bool))[None, None], seed=seed,
                      method=jm.init_all)
    out = params["output"]["kernel"]
    if eos == "likely":
        out[:, jcfg.eos] += 1.5
    elif eos == "rare":
        out *= 4.0
        out[:, jcfg.eos] = 0.0
    pm = par.ARTransformer(_pcfg(jcfg))
    load_jax_params(pm, params)
    return jm, params, pm.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_forward_prefill_and_decode_match_jax():
    jm, params, pm = _pair()
    c = JCFG
    rng = np.random.default_rng(1)
    B, S = 2, 12
    emb = rng.standard_normal((B, S, c.dim)).astype(np.float32)
    pos = np.stack([np.arange(S), np.r_[np.arange(5), np.arange(S - 5)]]).astype(np.int32)
    mask = np.tril(np.ones((S, S), bool))[None, None].repeat(B, 0)
    mask[1, :, :, :2] = False
    mask[1, :, np.arange(2), np.arange(2)] = True  # pad queries attend to themselves
    v = {"params": params}
    j_logits = jm.apply(v, emb, pos, mask)
    with torch.no_grad():
        p_logits = pm(_t(emb), _t(pos).long(), _t(mask))
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(j_logits), atol=TOL)

    shape = (c.n_layer, B, c.max_seq_len, c.n_local_heads, c.head_dim)
    # the JAX prefill attends over the whole cache: its mask spans every slot
    cache_mask = np.pad(mask, ((0, 0), (0, 0), (0, 0), (0, c.max_seq_len - S)))
    j_last, jk, jv = jm.apply(v, emb, pos, cache_mask, jnp.zeros(shape), jnp.zeros(shape),
                              method=jm.prefill)
    kc, vc = pm.new_caches(B, "cpu", torch.float32)
    with torch.no_grad():
        p_last = pm.prefill(_t(emb), _t(pos).long(), _t(mask), kc, vc)
    np.testing.assert_allclose(p_last.numpy(), np.asarray(j_last), atol=TOL)
    np.testing.assert_allclose(kc.transpose(2, 3).numpy(), np.asarray(jk), atol=TOL)
    np.testing.assert_allclose(vc.transpose(2, 3).numpy(), np.asarray(jv), atol=TOL)

    x1 = rng.standard_normal((B, 1, c.dim)).astype(np.float32)
    in_pos, min_key = np.array([S, S - 5], np.int32), np.array([0, 2], np.int32)
    j_dec, jk, jv = jm.apply(v, x1, in_pos, S, jk, jv, min_key=min_key,
                             method=jm.decode_step)
    with torch.no_grad():
        p_dec = pm.decode_step(_t(x1), _t(in_pos).long(), torch.tensor(S), kc, vc,
                               _t(min_key).long())
    np.testing.assert_allclose(p_dec.numpy(), np.asarray(j_dec), atol=TOL)
    np.testing.assert_allclose(kc.transpose(2, 3).numpy(), np.asarray(jk), atol=TOL)


def test_decode_step_continues_prefill_as_the_full_forward():
    _, _, pm = _pair(seed=2)
    c = JCFG
    rng = np.random.default_rng(3)
    S = 10
    emb = torch.from_numpy(rng.standard_normal((1, S, c.dim)).astype(np.float32))
    pos = torch.arange(S)[None]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool))[None, None]
    kc, vc = pm.new_caches(1, "cpu", torch.float32)
    with torch.no_grad():
        full = pm(emb, pos, mask)
        pm.prefill(emb[:, :-1], pos[:, :-1], mask[..., :-1, :-1], kc, vc)
        step = pm.decode_step(emb[:, -1:], pos[:, -1], torch.tensor(S - 1), kc, vc)
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), atol=TOL)


# (temperature, top_p, repetition_penalty, suppress_eos, penalised entries)
SAMPLE_CASES = {
    "defaults": (0.7, 0.7, 1.5, False, "some"),
    "suppress_eos": (0.7, 0.7, 1.5, True, "some"),
    "penalty_on_eos_then_suppressed": (0.7, 0.7, 2.0, True, "all"),
    "no_penalty": (1.0, 0.7, 1.0, False, "none"),
    "top_p_zero_keeps_one": (0.7, 0.0, 1.5, False, "some"),
    "top_p_one": (1.3, 1.0, 1.5, False, "some"),
    "top_p_narrow": (0.7, 0.2, 1.2, False, "some"),
    "temperature_floor": (0.0, 0.9, 1.5, False, "some"),
    "hot": (5.0, 0.95, 1.5, True, "some"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_token_matches_jax(case):
    temp, top_p, rp, suppress, penal = SAMPLE_CASES[case]
    V, n = 33, 64
    rng = np.random.default_rng(sorted(SAMPLE_CASES).index(case))
    logits = (2.0 * rng.standard_normal((n, V))).astype(np.float32)
    pm = {"some": rng.random((n, V)) < 0.2, "all": np.ones((n, V), bool),
          "none": np.zeros((n, V), bool)}[penal]
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    j_tok = jax.jit(jax.vmap(lambda k, lg, m: jar.sample_token(
        k, lg, m, temperature=temp, top_p=top_p, repetition_penalty=rp,
        suppress_eos=suppress, eos=V - 1)))(keys, logits, pm)
    q = jax.vmap(lambda k: jax.random.exponential(k, (V,)))(keys)
    p_tok = par.sample_token(_t(logits), _t(pm), _t(q), temperature=temp, top_p=top_p,
                             repetition_penalty=rp, suppress_eos=suppress, eos=V - 1)
    np.testing.assert_array_equal(p_tok.numpy(), np.asarray(j_tok))
    if suppress:
        assert (p_tok != V - 1).all()


def _generate_inputs(jcfg, B, C_max, P_max, cond_lens, prompt_lens, seed):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((B, C_max, jcfg.dim)).astype(np.float32)
    prompt = rng.integers(0, jcfg.vocab_size - 1, (B, P_max)).astype(np.int32)
    return cond, np.array(cond_lens, np.int32), prompt, np.array(prompt_lens, np.int32)


def _both_generate(jcfg, eos, max_new, scope, inputs, seed=0,
                   knobs=(0.8, 0.8, 1.3)):
    jm, params, pm = _pair(jcfg, eos=eos)
    cond, cond_lens, prompt, prompt_lens = inputs
    key = jax.random.PRNGKey(seed)
    fn = jax.jit(jar.make_generate_fn(jm, max_new_tokens=max_new, penalty_scope=scope))
    j_tok, j_n = fn({"params": params}, cond, cond_lens, prompt, prompt_lens, key,
                    *map(jnp.float32, knobs))
    gen = par.ARGenerator(pm, max_new, penalty_scope=scope, device="cpu")
    temp, top_p, rp = knobs
    p_tok, p_n = gen.generate(_t(cond), _t(cond_lens), _t(prompt), _t(prompt_lens),
                              temperature=temp, top_p=top_p, repetition_penalty=rp,
                              draws=jax_ar_draws(key, cond.shape[0], jcfg.vocab_size, max_new))
    return (np.asarray(j_tok), np.asarray(j_n)), (p_tok.numpy(), p_n.numpy()), gen


@pytest.mark.parametrize("scope", ["first", "all"])
def test_generate_matches_jax(scope):
    """Three left-padded rows (different cond and prompt lengths); EOS made
    likely enough that rows stop at different steps before the limit."""
    inputs = _generate_inputs(JCFG, 3, 16, 8, (16, 9, 4), (8, 3, 0), seed=5)
    (j_tok, j_n), (p_tok, p_n), gen = _both_generate(JCFG, "likely", 40, scope, inputs)
    np.testing.assert_array_equal(p_n, j_n)
    np.testing.assert_array_equal(p_tok, j_tok)
    assert len(set(j_n.tolist())) > 1 and j_n.min() < 40, j_n
    assert gen.decode_steps < 39 and gen.replays == 0 and gen.graph is None


def test_generate_position_clamps_match_jax():
    """max_seq_len 32 with 2 + 12 + 8 prefill slots and 40 new tokens: the
    kv slot and the RoPE positions run past the table, and both sides clamp
    them (EOS made rare so every row runs to the limit)."""
    jcfg = dataclasses.replace(JCFG, max_seq_len=32)
    inputs = _generate_inputs(jcfg, 2, 12, 8, (12, 7), (8, 5), seed=6)
    (j_tok, j_n), (p_tok, p_n), gen = _both_generate(jcfg, "rare", 40, "first", inputs, seed=1)
    np.testing.assert_array_equal(p_n, j_n)
    np.testing.assert_array_equal(p_tok, j_tok)
    assert (j_n == 40).all() and gen.decode_steps == 39
