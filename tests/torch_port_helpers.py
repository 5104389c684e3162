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


def port_cfg(j):
    """A JAX package config dataclass rebuilt, field for field, in the port's
    ``seedvc_tpu_torch.core.config`` classes of the same names."""
    import dataclasses

    from seedvc_tpu_torch.core import config as pc

    if not dataclasses.is_dataclass(j):
        return j
    cls = getattr(pc, type(j).__name__)
    return cls(**{f.name: port_cfg(getattr(j, f.name)) for f in dataclasses.fields(j)})


def jax_train_draws(key, B, T, n_mels, p, dtype=None):
    """The draws the JAX v1 train step makes from its step key ``key``, as the
    port's ``TrainDraws`` (torch tensors): ``split(key, 4)`` gives the
    prompt, t, noise and drop keys (``train/step.py::loss_fn``); the prompt
    key splits into the fraction and the zero mask (``models/vc.py``); t is
    uniform, the noise normal in ``dtype`` (the step's compute dtype; f32
    default) and the dropout mask Bernoulli(p), drawn only when p > 0
    (``models/cfm.py``)."""
    import jax.numpy as jnp

    from seedvc_tpu_torch.models.vc import TrainDraws

    keys = jax.random.split(key, 4)
    key_len, key_zero = jax.random.split(keys[0])
    frac = jax.random.uniform(key_len, (B,))
    zero = jax.random.bernoulli(key_zero, 0.1, (B,))
    t = jax.random.uniform(keys[1], (B,), dtype=jnp.float32)
    noise = jax.random.normal(keys[2], (B, T, n_mels), dtype=dtype or jnp.float32)
    drop = (jax.random.bernoulli(keys[3], p, (B,)).astype(jnp.float32) if p > 0 else None)

    def tt(a):
        return torch.from_numpy(np.array(a, np.float32))

    return TrainDraws(tt(frac), torch.from_numpy(np.array(zero)), tt(t), tt(noise),
                      None if drop is None else tt(drop))


# ---------------------------------------------------------------------------
# the training slice's tiny config and batches

B, T, T_S, N_MELS, S_DIM = 2, 48, 24, 80, 192


def tiny_train_cfg(**over):
    """A small whisper_small_wavenet: every branch of its DiT (U-ViT and long
    skips, WaveNet head, flash attention) at 64 wide, 2 heads, depth 3.
    ``reg=`` / ``dit=`` override regulator / DiT fields."""
    from seedvc_tpu.core import config as jc

    reg = dict(channels=32, is_discrete=False, in_channels=48, sampling_ratios=(1, 1))
    dit = dict(hidden_dim=64, num_heads=2, depth=3, in_channels=N_MELS, content_dim=32,
               final_layer_type="wavenet", long_skip_connection=True,
               uvit_skip_connection=True, use_flash_attention=True)
    reg.update(over.pop("reg", {}))
    dit.update(over.pop("dit", {}))
    mp = jc.ModelParams(length_regulator=jc.LengthRegulatorConfig(**reg),
                        DiT=jc.DiTConfig(**dit),
                        wavenet=jc.WavenetConfig(hidden_dim=32, num_layers=2))
    return jc.SeedVCConfig(model_params=mp)


def vc_tree(mp, seed=3):
    """A random flax tree of the JAX ``VCModel`` of ``mp`` (numpy)."""
    import jax.numpy as jnp

    from seedvc_tpu.models.vc import VCModel as JVCModel

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    key = jax.random.PRNGKey(0)
    return jax_init(JVCModel(mp), z(1, 16, 48), z(1, 16, 48), z(1, 16, N_MELS),
                    jnp.full((1,), 16, jnp.int32), z(1, S_DIM), seed=seed, deterministic=True,
                    rngs_dict={"prompt": key, "t": key, "noise": key, "drop": key})


def train_batch(seed=0, f0=False):
    """A prepared training batch (numpy) at the tiny config's widths."""
    rng = np.random.default_rng(seed)
    b = {"s_alt": rng.standard_normal((B, T_S, 48)).astype(np.float32),
         "s_ori": rng.standard_normal((B, T_S, 48)).astype(np.float32),
         "mels": rng.standard_normal((B, T, N_MELS)).astype(np.float32) - 4.0,
         "mel_lens": np.array([T, 37], np.int32),
         "style": rng.standard_normal((B, S_DIM)).astype(np.float32),
         "s_lens": np.array(21, np.int32)}
    if f0:
        b["f0"] = np.where(rng.random((B, 40)) < 0.3, 0.0,
                           rng.uniform(80, 400, (B, 40))).astype(np.float32)
        b["f0_lens"] = np.array(33, np.int32)
    return b


# ---------------------------------------------------------------------------
# the trainer's parity tests (tests/test_torch_trainer*.py)

def trainer_wav_dir(d):
    """Four 1.0-1.4 s tones with noise and one too-short clip (which the
    md5 rule replaces), at 22.05 kHz, written into ``d``."""
    from seedvc_tpu.apps.audio_io import save_wav

    SR = 22050
    rng = np.random.default_rng(0)
    for i in range(4):
        t = np.arange(SR + i * 3000) / SR
        wave = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
        save_wav(str(d / f"a{i}.wav"), wave.astype(np.float32), SR)
    save_wav(str(d / "short.wav"), np.zeros(1000, np.float32), SR)  # replaced by the md5 rule
    return str(d)


TRAINER_WHISPER = dict(d_model=48, n_layers=1, n_heads=4, ffn_dim=96)


def trainer_trees():
    """(JAX config, flax trees of a 48-wide one-layer Whisper, CAMPPlus and
    the tiny VCModel with an MLP head, no skips and depth 2: every DiT branch
    is held by tests/test_torch_train_losses.py, and the JAX trainer's
    compile time grows with each)."""
    import jax.numpy as jnp

    from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
    from seedvc_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
    from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig

    z = lambda *s: jnp.zeros(s)  # noqa: E731
    jcfg = tiny_train_cfg(dit=dict(depth=2, final_layer_type="mlp",
                                   long_skip_connection=False, uvit_skip_connection=False))
    return jcfg, dict(
        whisper_params=jax_init(JWhisperEncoder(JWhisperEncoderConfig(**TRAINER_WHISPER)),
                                z(1, 3000, 80), seed=1),
        campplus_params=jax_init(JCAMPPlus(), z(1, 300, 80), seed=2),
        vc_params=vc_tree(jcfg.model_params, seed=3))


def _trainer_cfgs(wav_dir):
    from seedvc_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from seedvc_tpu_torch.train.trainer import TrainerConfig

    base = dict(data_path=wav_dir, run_dir="", batch_size=2, epochs=2, max_steps=2,
                log_interval=1, save_interval=1000, mel_bucket=64, warmup_steps=1, base_lr=1e-3)
    return JTrainerConfig(**base), TrainerConfig(**base)


def jax_chain_draws(p):
    """The port's ``draws_fn`` replaying the JAX loop's key schedule: from
    ``PRNGKey(seed)``, ``key, sub = split(key)`` once a step."""
    def draws_fn(key, shape, device):
        seed, step = key
        k = jax.random.PRNGKey(seed)
        for _ in range(step + 1):
            k, sub = jax.random.split(k)
        return jax_train_draws(sub, *shape, p)

    return draws_fn


def trainer_pair(wav_dir, **extra):
    """A JAX trainer (n_model=4 on the 8-device CPU mesh) and a port trainer
    on the CPU, on the same trees and config; the port draws JAX's draws.
    ``extra``: more keyword arguments for both constructors (numpy trees)."""
    from seedvc_tpu.models.whisper import WhisperEncoderConfig as JWhisperEncoderConfig
    from seedvc_tpu.train.trainer import Trainer as JTrainer
    from seedvc_tpu_torch.models.whisper import WhisperEncoderConfig
    from seedvc_tpu_torch.train.trainer import Trainer

    jcfg, params = trainer_trees()
    jt, pt = _trainer_cfgs(wav_dir)
    jtr = JTrainer(jcfg, jt, whisper_cfg=JWhisperEncoderConfig(**TRAINER_WHISPER), n_model=4,
                   **params, **extra)
    ptr = Trainer(port_cfg(jcfg), pt, whisper_cfg=WhisperEncoderConfig(**TRAINER_WHISPER),
                  device="cpu", draws_fn=jax_chain_draws(jcfg.model_params.DiT.class_dropout_prob),
                  **params, **extra)
    return jtr, ptr


# ---------------------------------------------------------------------------
# OpenVoice (tests/test_torch_openvoice.py, test_torch_trainer_openvoice.py, test_torch_eval.py)

def ov_tiny_cfg(mod):
    """The tiny config of tests/test_openvoice.py in ``mod``'s
    ``OpenVoiceConfig`` (the JAX or the port module): inter 8, hidden 16, one
    ResBlock, two 4x upsamplings, gin 12."""
    return mod.OpenVoiceConfig(
        spec_channels=513, inter_channels=8, hidden_channels=16,
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
        upsample_rates=(4, 4), upsample_initial_channel=32,
        upsample_kernel_sizes=(8, 8), gin_channels=12, zero_g=True)


def ov_tree(jcfg, seed=0):
    """A random flax tree (numpy) of the JAX ToneColorConverter of ``jcfg``:
    the voice_conversion branch and the reference encoder (which setup
    builds lazily), merged. Every leaf is drawn, each coupling's ``post``
    included (a fresh JAX init zeroes it, which makes the flow the identity
    and g inert)."""
    import jax.numpy as jnp

    from seedvc_tpu.models.openvoice import ToneColorConverter

    m = ToneColorConverter(jcfg)
    T, g = 16, jnp.zeros((1, jcfg.gin_channels))
    vc = jax_init(m, jnp.zeros((1, T, jcfg.spec_channels)), jnp.array([T]), g, g,
                  jnp.zeros((1, T, jcfg.inter_channels)), 0.3,
                  method=m.voice_conversion, seed=seed)
    ref = jax_init(m, jnp.zeros((1, T, jcfg.spec_channels)), method=m.extract_se, seed=seed + 1)
    return {**vc, **ref}


# ---------------------------------------------------------------------------
# the v2 trainer's parity tests (tests/test_torch_trainer_v2*.py, test_torch_v2_losses.py)

def v2_port_cfg(j):
    """A JAX ``V2Config`` rebuilt in the port's config classes."""
    import dataclasses

    from seedvc_tpu_torch.models.ar import ARConfig
    from seedvc_tpu_torch.models.astral import AstralConfig
    from seedvc_tpu_torch.models.dit_v2 import DiTV2Config
    from seedvc_tpu_torch.models.ssl import SSLConfig
    from seedvc_tpu_torch.pipelines.convert_v2 import V2Config

    def same(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})

    return V2Config(sr=j.sr, hop=j.hop, n_mels=j.n_mels, dit=same(DiTV2Config, j.dit),
                    ar=same(ARConfig, j.ar), ssl=same(SSLConfig, j.ssl),
                    narrow=same(AstralConfig, j.narrow), wide=same(AstralConfig, j.wide),
                    prompt_cap_frames=j.prompt_cap_frames, context_frames=j.context_frames,
                    max_ref_sec=j.max_ref_sec)


def v2_trees(cfg, seed=1, frozen=True):
    """Random flax trees (numpy) of the v2 trainer's modules for the JAX
    ``V2Config`` ``cfg``: ``frozen`` (ssl, narrow, wide, campplus; None with
    ``frozen=False``) and ``trainable`` (dit, cfm_reg, ar, ar_reg)."""
    import jax.numpy as jnp

    from seedvc_tpu.core.config import LengthRegulatorConfig as JRegCfg
    from seedvc_tpu.models.ar import ARTransformer as JAR
    from seedvc_tpu.models.astral import AstralQuantizer as JAstral
    from seedvc_tpu.models.campplus import CAMPPlus as JCAMPPlus
    from seedvc_tpu.models.dit_v2 import DiTV2 as JDiTV2
    from seedvc_tpu.models.regulator import InterpolateRegulator as JReg
    from seedvc_tpu.models.ssl import SSLEncoder as JSSL

    z = jnp.zeros
    reg = dict(is_discrete=True)
    ar = JAR(cfg.ar)
    frozen = None if not frozen else {
        "ssl": jax_init(JSSL(cfg.ssl), z((1, 16000)), seed=seed),
        "narrow": jax_init(JAstral(cfg.narrow), z((1, 50, cfg.ssl.d_model)), seed=seed + 1),
        "wide": jax_init(JAstral(cfg.wide), z((1, 50, cfg.ssl.d_model)), seed=seed + 2),
        "campplus": jax_init(JCAMPPlus(feat_dim=80, embedding_size=cfg.dit.style_encoder_dim),
                             z((1, 300, 80)), seed=seed + 3)}
    trainable = {
        "dit": jax_init(JDiTV2(cfg.dit), z((1, 16, cfg.n_mels)), z((1, 16, cfg.n_mels)),
                        jnp.array([16]), z((1,)), z((1, cfg.dit.style_encoder_dim)),
                        z((1, 16, cfg.dit.content_dim)), seed=seed + 4),
        "cfm_reg": jax_init(JReg(JRegCfg(channels=cfg.dit.content_dim,
                                         content_codebook_size=cfg.wide.codebook_size,
                                         sampling_ratios=(1, 1, 1, 1), **reg)),
                            z((1, 8), jnp.int32), jnp.array([16]), 16, seed=seed + 5),
        "ar": jax_init(ar, z((1, 4), jnp.int32), jnp.arange(4)[None],
                       jnp.tril(jnp.ones((4, 4), bool))[None, None], seed=seed + 6,
                       method=ar.init_all),
        "ar_reg": jax_init(JReg(JRegCfg(channels=cfg.ar.dim,
                                        content_codebook_size=cfg.narrow.codebook_size,
                                        sampling_ratios=(), **reg)),
                           z((1, 8), jnp.int32), jnp.array([8]), 8, seed=seed + 7)}
    return frozen, trainable


def jax_v2_draws(key, B, T, n_mels, p):
    """The draws the JAX v2 step makes from its key (``TrainerV2._losses``):
    ``split(key, 6)`` gives the prompt fractions, the prompt drop
    (Bernoulli(p)), the content drop (Bernoulli(0.5) and the prompt drop), t
    and the noise (``cfm_v2_loss``); as the port's ``TrainDrawsV2``."""
    import jax.numpy as jnp

    from seedvc_tpu_torch.train.trainer_v2 import TrainDrawsV2

    keys = jax.random.split(key, 6)
    pd = jax.random.bernoulli(keys[1], p)
    cd = jax.random.bernoulli(keys[2], 0.5) & pd
    t = jax.random.uniform(keys[3], (B,), dtype=jnp.float32)
    noise = jax.random.normal(keys[4], (B, T, n_mels), dtype=jnp.float32)
    return TrainDrawsV2(torch.from_numpy(np.array(jax.random.uniform(keys[0], (B,)))),
                        torch.tensor(bool(pd)), torch.tensor(bool(cd)),
                        torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise)))


def jax_v2_chain_draws(p):
    """The port's v2 ``draws_fn`` replaying JAX's keys: a step key
    ``(seed, step)`` takes the loop's chain from ``PRNGKey(seed)`` (``key,
    sub = split(key)`` once a step), a validation key ``(seed + i,)`` is
    ``PRNGKey(seed + i)`` itself."""
    def draws_fn(key, shape, device):
        if len(key) == 1:
            return jax_v2_draws(jax.random.PRNGKey(key[0]), *shape, p)
        seed, step = key
        k = jax.random.PRNGKey(seed)
        for _ in range(step + 1):
            k, sub = jax.random.split(k)
        return jax_v2_draws(sub, *shape, p)

    return draws_fn


def v2_batch(seed=0, B=2, T=33000):
    """A dataset batch of noise at 22.05 kHz, its first 24000 samples as the
    16 kHz waves (the JAX trainer tests' batch)."""
    from seedvc_tpu_torch.train.dataset import Batch

    rng = np.random.default_rng(seed)
    waves = (rng.standard_normal((B, T)) * 0.1).astype(np.float32)
    return Batch(waves, waves[:, :24000], np.array([T, T - 4000], np.int32),
                 np.array([24000, 21000], np.int32))
