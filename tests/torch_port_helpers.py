"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np
import torch


def np_tree(tree):
    """A flax params tree with numpy leaves, as load_jax_params takes it."""
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_init(module, *args, seed=0, **kwargs):
    """Random params for a flax module, drawn with numpy from the shapes of
    its init (no init compile): kernels ~ N(0, 1/fan_in), norm scales and
    BatchNorm variances near 1, other leaves ~ N(0, 0.1). Returns numpy."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("kernel"):
            fan_in = int(np.prod(s.shape[:-1])) or 1
            a = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name in ("scale", "weight", "var"):
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(s.shape))
        else:
            a = 0.1 * rng.standard_normal(s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_apply(module, params, *args, **kwargs):
    """``module.apply`` under jit (one compile instead of op-by-op dispatch)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kwargs))(params, *args)


def tiny_xlsr(prompt_cap=64, context=192):
    """A tiny ``xlsr_tiny``-shaped converter pair on the same random weights:
    (JAX VoiceConverter, port VoiceConverter on the CPU, the flax trees).
    SSL encoder 64 wide (1 layer, 32 conv channels), DiT 64 wide with both
    prefix tokens and flash attention on (2 heads, depth 3, MLP head),
    regulator 64 wide, HiFT with 32 base channels; f32."""
    import dataclasses

    import jax.numpy as jnp

    from seedvc_tpu.core.config import get_preset as j_get_preset
    from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
    from seedvc_tpu.models.hifigan import HiFTConfig as JHiFTConfig
    from seedvc_tpu.models.hifigan import HiFTGenerator as JHiFTGenerator
    from seedvc_tpu.models.ssl import SSLConfig as JSSLConfig
    from seedvc_tpu.models.ssl import SSLEncoder as JSSLEncoder
    from seedvc_tpu.models.vc import VCModel as JVCModel
    from seedvc_tpu.pipelines.convert import VoiceConverter as JVoiceConverter
    from seedvc_tpu_torch.core import config as pc
    from seedvc_tpu_torch.models.hifigan import HiFTConfig
    from seedvc_tpu_torch.models.ssl import SSLConfig
    from seedvc_tpu_torch.pipelines.convert import VoiceConverter

    ssl = dict(conv_dim=32, d_model=64, n_layers=1, n_heads=4, ffn_dim=128)
    reg = dict(channels=64, in_channels=64)
    dit = dict(hidden_dim=64, num_heads=2, depth=3, content_dim=64)
    hift = dict(base_channels=32)

    def shrink(cfg):
        mp = cfg.model_params
        mp = dataclasses.replace(
            mp, length_regulator=dataclasses.replace(mp.length_regulator, **reg),
            DiT=dataclasses.replace(mp.DiT, **dit))
        return dataclasses.replace(cfg, model_params=mp)

    jcfg = shrink(j_get_preset("xlsr_tiny"))
    pcfg = shrink(pc.get_preset("xlsr_tiny"))
    z = lambda *s: jnp.zeros(s)  # noqa: E731
    key = jax.random.PRNGKey(0)
    T0 = 32
    params = dict(
        whisper_params=jax_init(JSSLEncoder(JSSLConfig(**ssl)), z(1, 16000), seed=1),
        campplus_params=jax_init(JCAMPPlus(), z(1, 300, 80), seed=2),
        vc_params=jax_init(JVCModel(jcfg.model_params), z(1, T0, 64), z(1, T0, 64),
                           z(1, T0, 80), jnp.full((1,), T0, jnp.int32), z(1, 192), seed=3,
                           deterministic=True,
                           rngs_dict={"prompt": key, "t": key, "noise": key, "drop": key}),
        vocoder_params=jax_init(JHiFTGenerator(JHiFTConfig(**hift)), z(1, 16, 80), key,
                                seed=4))
    common = dict(prompt_cap_frames=prompt_cap, context_frames=context)
    jvc = JVoiceConverter(jcfg, whisper_cfg=JSSLConfig(**ssl),
                          vocoder_cfg=JHiFTConfig(**hift), compute_dtype=jnp.float32,
                          **common, **params)
    pvc = VoiceConverter(pcfg, whisper_cfg=SSLConfig(**ssl), vocoder_cfg=HiFTConfig(**hift),
                         device="cpu", **common, **params)
    return jvc, pvc, params


def jax_hift_draws(shape, key=None):
    """The draws the JAX ``sine_source`` makes from ``key`` (the pipelines'
    ``PRNGKey(0)`` by default) for noise of ``shape`` (B, T, H), as torch
    tensors: phase (B, 1, H) uniform in [-pi, pi), noise (B, T, H)."""
    B, T, H = shape
    k_phase, k_noise = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    phase = jax.random.uniform(k_phase, (B, 1, H), minval=-np.pi, maxval=np.pi)
    return (torch.from_numpy(np.array(phase)),
            torch.from_numpy(np.array(jax.random.normal(k_noise, (B, T, H)))))


def jax_ar_draws(key, B, vocab, max_new_tokens):
    """The exponential draws the JAX AR ``generate`` makes from ``key``, as a
    torch tensor (max_new_tokens, B, vocab): its key schedule is ``key, sub =
    split(key)``, then ``split(sub, B)`` and one ``exponential(sub_b,
    (vocab,))`` a row, first for the first token and then once a step."""
    def body(k, _):
        k, sub = jax.random.split(k)
        subs = jax.random.split(sub, B)
        return k, jax.vmap(lambda s: jax.random.exponential(s, (vocab,)))(subs)

    _, q = jax.jit(lambda k: jax.lax.scan(body, k, None, length=max_new_tokens))(key)
    return torch.from_numpy(np.array(q))
