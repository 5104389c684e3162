"""v1 fine-tuning trainer on one GPU (port of ``seedvc_tpu/train/trainer.py``).

- frozen encoders: Whisper (in ``encoder_dtype``) for the content, CAMPPlus
  for the style from a kaldi fbank over the true frame lengths, RMVPE for the
  F0 of F0-conditioned presets; the trainable unit is ``VCModel`` (regulator
  + CFM) in f32 master weights,
- timbre perturbation of the content encoder's input: with
  ``openvoice_params`` the OpenVoice converter (``models/openvoice.py``,
  frozen, f32) re-voices the batch at tau 0.3 to a target speaker embedding,
  the ``se_db`` bank's row ``(step * B + b) % len(se_db)`` or, without a
  bank, the batch's own embeddings shuffled; otherwise a random-rate time
  warp of the 16 kHz batch (``dsp.resample.warp_rate``). The host numpy
  generator ``default_rng((seed, step))`` draws what the JAX trainer draws,
  in its order (the warp rate; or the shuffle, then the converter's noise),
  so both trainers perturb a batch alike,
- a per-clip feature cache of the perturbation-invariant features (clean
  content and style) bounded by ``feat_cache_bytes``,
- ``prepare_batch``: the mel and its -10 pad on the device in 128-frame
  buckets, the 16 kHz batch in 1 s buckets, content cropped to its true
  token count in 64-token buckets,
- the loop: batches prepared ``prefetch`` ahead on a worker thread, one step
  key ``(seed, step)`` a step, a loss EMA kept on the device and read only at
  ``log_interval``, LR halving on a plateau, validation with early stop,
- checkpoints in the port's own ``torch.save`` format under ``run_dir``
  (newest two kept, one save a step), and ``export_serving``: ``vc.pkl``, a
  flax-layout tree of numpy arrays (EMA weights preferred) that the port's
  ``VoiceConverter(vc_params=...)`` and the JAX package load.

Device: ``cuda`` unless the caller passes ``device="cpu"``; without a card the
constructor raises.

Several GPUs: one process a GPU in a process group
(``parallel.distributed.initialize``, e.g. under ``torchrun``), laid out as
a (data, model) mesh with ``n_data = world_size // n_model``, as the JAX
trainer lays its devices. The state goes through ``shard_state`` (tensor
parallel over ``model``, FSDP over ``data`` with ``fsdp`` for parameters of
the constructor's ``fsdp_min_elems``, JAX's 65536, or more) and the steps
through ``make_sharded_train_step`` on every mesh, 1 x 1 included. Each rank
prepares only its rows of the batch (the frozen encoders and the
perturbation on them; the buckets, the warp rate and the draws from the
whole batch, so every mesh sees what one process sees); ``save`` writes full
tensors from the coordinator, ``restore_latest`` cuts them for any mesh,
and ``validate`` returns the global mean.
"""

from __future__ import annotations

import glob
import os
import pickle
import re
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from seedvc_tpu_torch.core.config import SeedVCConfig
from seedvc_tpu_torch.core.profiling import annotate
from seedvc_tpu_torch.dsp.fbank import kaldi_fbank
from seedvc_tpu_torch.dsp.mel import MelFrontend
from seedvc_tpu_torch.dsp.resample import resample, resample_kernel, warp_rate
from seedvc_tpu_torch.dsp.whisper_mel import CHUNK as WHISPER_CHUNK
from seedvc_tpu_torch.dsp.whisper_mel import whisper_log_mel
from seedvc_tpu_torch.models import openvoice
from seedvc_tpu_torch.models.campplus import CAMPPlus
from seedvc_tpu_torch.models.vc import VCModel
from seedvc_tpu_torch.models.whisper import WHISPER_SMALL, WhisperEncoder, WhisperEncoderConfig
from seedvc_tpu_torch.ops import attention
from seedvc_tpu_torch.parallel import collectives
from seedvc_tpu_torch.parallel.distributed import is_coordinator, world_size
from seedvc_tpu_torch.parallel.mesh import AXES, Mesh, data_rows, make_mesh
from seedvc_tpu_torch.train.dataset import Batch, FTDataset
from seedvc_tpu_torch.train.optim import (OptState, get_lr_scale, local, make_multi_optimizer,
                                          make_optimizer, set_lr_scale, warmup_cosine)
from seedvc_tpu_torch.train.prefetch import prefetched
from seedvc_tpu_torch.train.step import (TrainState, full_opt_state, gather_full, init_state,
                                         make_sharded_eval_step, make_sharded_train_step,
                                         shard_state)
from seedvc_tpu_torch.weights import load_jax_params, to_jax_params

CKPT_KEEP = 2


@dataclass
class TrainerConfig:
    data_path: str = ""          # dataset directory that train() reads when given none
    run_dir: str = "./runs/run1"  # checkpoints; "" = no checkpoints
    batch_size: int = 2
    epochs: int = 10
    max_steps: int = 1000
    base_lr: float = 1e-4
    warmup_steps: int = 100
    grad_clip: float = 10.0
    log_interval: int = 10
    save_interval: int = 500
    mel_bucket: int = 128        # mel frames rounded up to this multiple
    ema_decay: float = 0.99      # loss EMA for logging and the plateau rule
    lr_halve_patience: int = 4   # plateaued logs before the LR is halved
    validation_interval: int = 0  # steps between validate() (0 = off)
    weight_ema_decay: float = 0.0  # parameter EMA (0 = off)
    optimizer_kind: str = "single"  # "single": one AdamW; "multi": one per module
    val_batches: int = 4          # batches averaged per validation
    early_stop_patience: int = 10  # validations without improvement -> stop
    compute_dtype: str = "float32"  # or "bfloat16": bf16 activations, f32 masters
    # frozen Whisper's dtype; None = bfloat16 on cuda or under bf16 compute,
    # else float32 (features leave it in f32 either way)
    encoder_dtype: Optional[str] = None
    feat_cache_bytes: int = 2 << 30  # per-clip feature cache on the device; 0 = off
    # scatter params / AdamW moments / EMA over the data axis (FSDP2, ZeRO-3)
    fsdp: bool = False
    perturb_min: float = 0.85
    perturb_max: float = 1.15
    prefetch: int = 2             # batches prepared ahead on a worker thread; 0 = off
    seed: int = 1234


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (through pinned memory, without
    waiting, on cuda)."""
    t = torch.from_numpy(np.array(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def padded_mel(mel_fn: MelFrontend, waves: torch.Tensor,
               mel_lens: torch.Tensor) -> torch.Tensor:
    """The batch's mels with -10 past each clip's ``mel_lens`` frames."""
    mels = mel_fn(waves)
    pos = torch.arange(mels.shape[1], device=mels.device)[None, :]
    return torch.where((pos < mel_lens[:, None])[..., None], mels, torch.full_like(mels, -10.0))


def batch_style(campplus: CAMPPlus, w16: torch.Tensor, frame_lens: torch.Tensor) -> torch.Tensor:
    """CAMPPlus style from the true frame lengths: fbank over the padded 16 kHz
    batch, per-sample mean subtraction over the valid frames, masked."""
    fb = kaldi_fbank(w16)
    fmask = (torch.arange(fb.shape[1], device=fb.device)[None, :]
             < frame_lens[:, None]).to(fb.dtype)[..., None]
    mean = (fb * fmask).sum(dim=1, keepdim=True) / torch.clamp(
        frame_lens[:, None, None].to(fb.dtype), min=1.0)
    return campplus((fb - mean) * fmask, frame_lens)


def checkpoint_paths(run_dir: str) -> dict:
    """step -> path of the ``ckpt_<step>.pt`` files in ``run_dir``."""
    out = {}
    for p in glob.glob(os.path.join(run_dir, "ckpt_*.pt")):
        m = re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(p))
        if m:
            out[int(m.group(1))] = p
    return out


def latest_checkpoint(run_dir: str) -> Optional[int]:
    paths = checkpoint_paths(run_dir) if run_dir else {}
    return max(paths) if paths else None


def write_checkpoint(run_dir: str, step: int, tree: dict):
    """``torch.save`` ``tree`` as ``run_dir/ckpt_<step>.pt`` (through a
    temporary file) and keep the newest ``CKPT_KEEP``."""
    path = os.path.join(run_dir, f"ckpt_{step:08d}.pt")
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    paths = checkpoint_paths(run_dir)
    for old in sorted(paths)[:-CKPT_KEEP]:
        os.remove(paths[old])


def opt_state_tree(opt: OptState) -> dict:
    return {"lr_scale": opt.lr_scale, "names": opt.names,
            "groups": {g: {"count": gs.count, "mu": [t.cpu() for t in gs.mu],
                           "nu": [t.cpu() for t in gs.nu]} for g, gs in opt.groups.items()}}


def load_opt_state(opt: OptState, saved: dict, layout) -> OptState:
    """Copy a saved optimizer state (full tensors) into ``opt``'s tensors in
    place, each cut to this rank's piece by ``layout``; returns it with the
    saved ``lr_scale``."""
    if saved["names"] != opt.names:
        raise ValueError("checkpoint optimizer groups do not match this trainer's")
    for g, gs in opt.groups.items():
        src = saved["groups"][g]
        gs.count = int(src["count"])
        names = opt.names[g] * 2
        for name, dst, t in zip(names, gs.mu + gs.nu, src["mu"] + src["nu"]):
            dst.copy_(layout.scatter(name, t))
    return set_lr_scale(opt, float(saved["lr_scale"]))


def data_mesh(n_model: int, batch_size: int, device: torch.device) -> Mesh:
    """The trainers' (data, model) mesh over the process group's ranks:
    ``n_data = world_size // n_model``, which must divide ``batch_size``."""
    n_devices = world_size()
    if n_model < 1 or n_devices % n_model:
        raise ValueError(f"n_model {n_model} does not divide the {n_devices} ranks")
    n_data = n_devices // n_model
    if batch_size % n_data != 0:
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the data "
            f"axis size {n_data} (= {n_devices} devices / n_model {n_model})")
    return make_mesh(n_data=n_data, n_model=n_model, device_type=device.type)


def agree(flag: bool, mesh: Mesh) -> bool:
    """The coordinator's ``flag`` on every rank of ``mesh``."""
    group = mesh.all_group()
    if group is None:
        return flag
    import torch.distributed as dist

    t = torch.tensor([float(flag)], device=mesh.device_mesh.device_type)
    dist.broadcast(t, src=mesh.first_rank, group=group)
    return bool(t.item())


def save_state(run_dir: str, step: int, state):
    """Checkpoint ``state`` (params, optimizer, step, EMA when kept) as full
    tensors from the coordinator; every rank takes part in the gathers."""
    layout = state.layout
    params = gather_full(layout, state.params)
    opt = full_opt_state(state.opt_state, layout)
    ema = getattr(state, "ema_params", None)
    if ema is not None:
        ema = gather_full(layout, ema)
    if not is_coordinator():
        return
    tree = {"params": {n: p.detach().cpu() for n, p in params.items()},
            "opt_state": opt_state_tree(opt), "step": state.step}
    if ema is not None:
        tree["ema_params"] = {n: t.cpu() for n, t in ema.items()}
    write_checkpoint(run_dir, step, tree)


def load_state(tree: dict, state):
    """Copy a checkpoint's full tensors into ``state``'s pieces in place;
    returns (opt_state, step)."""
    layout = state.layout
    with torch.no_grad():
        for n, p in state.params.items():
            local(p).copy_(layout.scatter(n, tree["params"][n]))
    return load_opt_state(state.opt_state, tree["opt_state"], layout), int(tree["step"])


def _dtype(name: str) -> torch.dtype:
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported dtype {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


class Trainer:
    def __init__(self, cfg: SeedVCConfig, tcfg: TrainerConfig,
                 whisper_cfg: WhisperEncoderConfig = WHISPER_SMALL,
                 whisper_params=None, campplus_params=None, vc_params=None,
                 openvoice_params=None, se_db: Optional[np.ndarray] = None,
                 teacher_params=None, rmvpe_params=None, n_model: int = 1,
                 device=None, draws_fn=None, fsdp_min_elems: int = 65536):
        if tcfg.optimizer_kind not in ("single", "multi"):
            raise ValueError(f"unknown optimizer_kind {tcfg.optimizer_kind!r}")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to train on the CPU")
        if self.device.type == "cuda":  # f32 training and converter: no TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh = data_mesh(n_model, tcfg.batch_size, self.device)
        # the prep's own group: it runs on the prefetch thread beside the step
        self._prep_group = self.mesh.fresh_group(AXES.data)
        sp = cfg.preprocess_params.spect_params
        self.sr = cfg.preprocess_params.sr
        self.hop = sp.hop_length
        self.n_mels = sp.n_mels
        self.mel_fn = MelFrontend(self.sr, sp)
        self.compute_dtype = _dtype(tcfg.compute_dtype)
        if tcfg.encoder_dtype is not None:
            self.enc_dtype = _dtype(tcfg.encoder_dtype)
        else:
            self.enc_dtype = (torch.bfloat16 if self.compute_dtype == torch.bfloat16
                              or self.device.type == "cuda" else torch.float32)
        mp = cfg.model_params
        self.f0_condition = bool(mp.DiT.f0_condition)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tcfg.seed)
            self.whisper = WhisperEncoder(whisper_cfg)
            self.campplus = CAMPPlus(feat_dim=80, embedding_size=mp.style_encoder.dim)
            self.model = VCModel(mp)
            rmvpe_model = None
            if self.f0_condition:
                from seedvc_tpu_torch.models.rmvpe import RMVPE_E2E

                rmvpe_model = RMVPE_E2E()
        for module, tree in ((self.whisper, whisper_params), (self.campplus, campplus_params),
                             (self.model, vc_params), (rmvpe_model, rmvpe_params)):
            if module is not None and tree is not None:
                load_jax_params(module, tree)
        for frozen in (self.whisper, self.campplus, rmvpe_model):
            if frozen is not None:
                frozen.requires_grad_(False).eval().to(self.device)
        self.whisper.to(self.enc_dtype)
        self.rmvpe = None
        if rmvpe_model is not None:
            from seedvc_tpu_torch.models.rmvpe import RMVPE

            self.rmvpe = RMVPE(rmvpe_model)
        self.model.to(self.device).train()
        # the OpenVoice perturbation, when its weights are given (se_db alone
        # picks nothing: the JAX trainer uses the bank only with the converter)
        self.openvoice = None
        self.se_db = None if se_db is None else np.asarray(se_db, np.float32)
        if openvoice_params is not None:
            ov = openvoice.ToneColorConverter(openvoice.OpenVoiceConfig())
            self.openvoice = load_jax_params(ov, openvoice_params).requires_grad_(False).eval()
            self.openvoice.to(self.device)
            self._to16k = resample_kernel(self.sr, 16000, self.device)

        schedule = warmup_cosine(tcfg.base_lr, tcfg.warmup_steps, tcfg.max_steps)
        make = make_multi_optimizer if tcfg.optimizer_kind == "multi" else make_optimizer
        self.optimizer = make(schedule, grad_clip=tcfg.grad_clip)
        self.state: TrainState = shard_state(
            init_state(self.model, self.optimizer, ema=tcfg.weight_ema_decay > 0), self.mesh,
            fsdp=tcfg.fsdp, fsdp_min_elems=fsdp_min_elems, model=self.model)
        self.step_fn = make_sharded_train_step(
            self.model, self.optimizer, self.mesh, teacher_params=teacher_params,
            weight_ema_decay=tcfg.weight_ema_decay,
            compute_dtype=None if self.compute_dtype == torch.float32 else self.compute_dtype,
            draws_fn=draws_fn)
        self.eval_fn = make_sharded_eval_step(self.model, self.mesh, draws_fn=draws_fn)

        self._feat_cache: dict = {}  # clip id -> (s_ori row, style row), device tensors
        self._feat_cache_used = 0
        self.ema_loss: Optional[float] = None
        self._ema_dev: Optional[torch.Tensor] = None  # loss EMA on the device
        self.best_ema = float("inf")
        self.plateau_count = 0
        self.best_val_loss = float("inf")
        self.val_patience = 0
        # one record a step: step, mel frames T, host seconds of its prepare
        # (prep_s, on the prefetch thread), the loop's wait for it (wait_s),
        # host time at its end, the step's Span (span.host_s; span.device_s()
        # once its end event has completed), loss and grad norm (device
        # tensors, read by no one here) and the attention launches it made
        self.history: list[dict] = []
        if tcfg.run_dir:
            os.makedirs(tcfg.run_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def _put(self, x: np.ndarray) -> torch.Tensor:
        return to_device(x, self.device)

    def _whisper(self, w16: torch.Tensor) -> torch.Tensor:
        """Content features (f32) of a (B, T<=30 s) 16 kHz batch, the encoder
        on the wave zero-padded to its 30 s window."""
        mel = whisper_log_mel(w16).to(self.enc_dtype)
        return self.whisper(mel).float()

    def _perturb_openvoice(self, waves: torch.Tensor, rng: np.random.Generator,
                           step: int, B: Optional[int] = None,
                           rows: slice = slice(None)) -> torch.Tensor:
        """The OpenVoice conversion of the sr-rate batch ``waves`` (this
        rank's ``rows`` of a ``B``-row batch; default all), cut to whole
        256-sample frames, to the target speaker embeddings, resampled to
        16 kHz. Draws from ``rng``, for the whole batch: the batch shuffle
        when there is no ``se_db``, then the (B, frames, inter) noise."""
        ov = self.openvoice
        B = waves.shape[0] if B is None else B
        spec_len = waves.shape[1] // 256
        if self.se_db is not None:
            se_tgt = self._put(self.se_db[(step * B + np.arange(B)) % len(self.se_db)][rows])
        else:
            perm = torch.from_numpy(rng.permutation(B)).to(self.device)
            se = ov.extract_se(openvoice.linear_spectrogram(waves))
            # every rank's embeddings, since the shuffle crosses the ranks' rows
            se = torch.cat(collectives.all_gather_list(se, self._prep_group))
            se_tgt = se[perm][rows]
        noise = self._put(rng.standard_normal((B, spec_len, ov.cfg.inter_channels))
                          .astype(np.float32)[rows])
        spec = openvoice.linear_spectrogram(waves[:, : spec_len * 256])
        lens = torch.full((spec.shape[0],), spec_len, dtype=torch.int32, device=self.device)
        converted = ov.voice_conversion(spec, lens, ov.extract_se(spec), se_tgt, noise, 0.3)
        return resample(converted, self.sr, 16000, self._to16k)

    @torch.no_grad()
    def prepare_batch(self, batch: Batch, rng: np.random.Generator,
                      cache: bool = True, step: Optional[int] = None) -> dict:
        """The step's inputs on the device from one dataset batch. ``rng``
        draws the perturbation (one ``uniform(perturb_min, perturb_max)`` warp
        rate, or the OpenVoice converter's draws); ``step`` (default: the
        state's) picks the ``se_db`` rows; ``cache=False`` bypasses the per-clip
        feature cache (validation: its clip ids index another dataset).

        On a mesh with ``data`` wider than 1 the features are this rank's rows
        of the batch; the sizes, the warp rate and the draws are the whole
        batch's."""
        tb = self.tcfg
        if step is None:
            step = self.state.step
        B = batch.waves.shape[0]
        rows = data_rows(self.mesh, B)
        with annotate("prep.host"):
            mel_lens = (batch.wave_lengths // self.hop).astype(np.int32)
            bucket = -(-int(mel_lens.max()) // tb.mel_bucket) * tb.mel_bucket
            waves = np.zeros((B, bucket * self.hop), np.float32)
            n = min(waves.shape[1], batch.waves.shape[1])
            waves[:, :n] = batch.waves[:, :n]
            waves_d = self._put(waves[rows])
            mel_lens_d = self._put(mel_lens[rows])
            mels = padded_mel(self.mel_fn, waves_d, mel_lens_d)

            # one 1 s-bucketed 16 kHz batch for every consumer
            w16_T = min(-(-batch.waves_16k.shape[1] // 16000) * 16000, 30 * 16000)
            w16b = np.zeros((B, w16_T), np.float32)
            nb = min(w16_T, batch.waves_16k.shape[1])
            w16b[:, :nb] = batch.waves_16k[:, :nb]
            eff_16k = np.minimum(batch.wave_16k_lengths, w16_T)
            frame_lens = np.maximum((eff_16k - 400) // 160 + 1, 1).astype(np.int32)
            w16 = self._put(w16b[rows])
            if self.openvoice is None:
                # the warp takes 1/rate: out[i] = wave[i * r] compresses by r
                alt = warp_rate(w16, np.float32(1.0 / rng.uniform(tb.perturb_min,
                                                                  tb.perturb_max)))
            else:
                # the converted wave at its own length; Whisper zero-pads it to 30 s
                alt = self._perturb_openvoice(waves_d, rng, step, B, rows)[:, :WHISPER_CHUNK]
        Bl = w16.shape[0]

        ids = batch.ids[rows] if (cache and tb.feat_cache_bytes > 0) else None
        if ids is not None and all(int(i) in self._feat_cache for i in ids):
            cached = [self._feat_cache[int(i)] for i in ids]
            with annotate("prep.style"):
                s_ori = torch.stack([c[0] for c in cached])
                style = torch.stack([c[1] for c in cached])
            with annotate("prep.encode"):
                s_alt = self._whisper(alt)
        else:
            # one encoder call for both; zero-padding them to one length leaves
            # the features as they were, since Whisper pads every row to 30 s
            T = max(w16.shape[1], alt.shape[1])
            with annotate("prep.encode"):
                s = self._whisper(torch.cat([F.pad(w16, (0, T - w16.shape[1])),
                                             F.pad(alt, (0, T - alt.shape[1]))]))
            s_ori, s_alt = s[:Bl], s[Bl:]
            with annotate("prep.style"):
                style = batch_style(self.campplus, w16, self._put(frame_lens[rows]))
            if ids is not None:
                for b, i in enumerate(ids):
                    i = int(i)
                    if i in self._feat_cache:
                        continue
                    row = (s_ori[b].clone(), style[b].clone())
                    size = sum(r.numel() * r.element_size() for r in row)
                    if self._feat_cache_used + size > tb.feat_cache_bytes:
                        break
                    self._feat_cache[i] = row
                    self._feat_cache_used += size
        # content cropped to the batch's true token count (len_16k // 320 + 1)
        # in 64-token buckets; the true count rides along as s_lens
        max16 = int(eff_16k.max())
        s_true = max16 // 320 + 1
        s_bucket = min(-(-s_true // 64) * 64, s_ori.shape[1], s_alt.shape[1])
        feats = {"s_alt": s_alt[:, :s_bucket], "s_ori": s_ori[:, :s_bucket],
                 "s_lens": self._put(np.asarray(min(s_true, s_bucket), np.int32)),
                 "mels": mels, "mel_lens": mel_lens_d, "style": style}
        if self.f0_condition:
            f0 = self.rmvpe.infer_from_audio_batch(w16b[rows])  # (B, T16 // 160 + 1)
            feats["f0"] = self._put(f0.astype(np.float32))
            feats["f0_lens"] = self._put(np.asarray(min(max16 // 160 + 1, f0.shape[1]),
                                                    np.int32))
        return feats

    # ------------------------------------------------------------------
    @property
    def lr_scale(self) -> float:
        return get_lr_scale(self.state.opt_state)

    def halve_lr(self):
        """Halve the runtime LR multiplier in the optimizer state."""
        scale = self.lr_scale * 0.5
        self.state = self.state._replace(opt_state=set_lr_scale(self.state.opt_state, scale))
        print(f"plateau: halving LR (scale {scale})")

    # ------------------------------------------------------------------
    def _ckpt_paths(self) -> dict:
        return checkpoint_paths(self.tcfg.run_dir)

    def latest_step(self) -> Optional[int]:
        return latest_checkpoint(self.tcfg.run_dir)

    def save(self, step: int):
        """Checkpoint the params, optimizer state, step and EMA at ``step``
        (``run_dir/ckpt_<step>.pt``) as full tensors; once a step, newest two
        kept. On a mesh every rank calls it and the coordinator writes."""
        if not self.tcfg.run_dir or agree(self.latest_step() == step, self.mesh):
            return
        save_state(self.tcfg.run_dir, step, self.state)

    def restore_latest(self) -> bool:
        """Load the newest checkpoint of ``run_dir`` into the trainer (cut to
        this rank's pieces); False if there is none. A checkpoint without EMA
        restored into a run with EMA seeds the EMA from its params."""
        latest = self.latest_step()
        if latest is None:
            return False
        tree = torch.load(checkpoint_paths(self.tcfg.run_dir)[latest], map_location=self.device,
                          weights_only=True)
        st = self.state
        opt, step = load_state(tree, st)
        ema = st.ema_params
        if ema is not None:
            src = tree.get("ema_params") or tree["params"]
            with torch.no_grad():
                for n, t in ema.items():
                    t.copy_(st.layout.scatter(n, src[n]))
        self.state = TrainState(st.params, opt, step, ema, st.layout)
        return True

    def export_serving(self, out_dir: Optional[str] = None, use_ema: bool = True) -> str:
        """Write the trained weights as ``vc.pkl``, a flax-layout tree of numpy
        arrays (EMA weights when kept and ``use_ema``), which
        ``VoiceConverter(vc_params=...)``, ``apps.infer --checkpoint-dir`` and
        the JAX package load."""
        out_dir = out_dir or os.path.join(self.tcfg.run_dir, "ft_model")
        st = self.state
        values = st.ema_params if use_ema and st.ema_params is not None else st.params
        tree = to_jax_params(self.model, gather_full(st.layout, values))
        path = os.path.join(out_dir, "vc.pkl")
        if is_coordinator():  # every rank gathered; one writes
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "wb") as f:
                pickle.dump(tree, f)
        return path

    # ------------------------------------------------------------------
    def validate(self, val_dataset: FTDataset) -> float:
        """Mean CFM loss over up to ``val_batches`` validation batches, each
        perturbed as a training batch at the current step."""
        tb = self.tcfg
        rng = np.random.default_rng(tb.seed + 1)
        losses = []
        for i, batch in enumerate(val_dataset.batches(shuffle=False, epoch=0)):
            if i >= tb.val_batches:
                break
            feats = self.prepare_batch(batch, rng, cache=False, step=self.state.step)
            losses.append(float(self.eval_fn(self.state.params, feats, (tb.seed + i,),
                                             local_rows=True)))
        return float(np.mean(losses)) if losses else float("nan")

    def train(self, dataset: Optional[FTDataset] = None,
              val_dataset: Optional[FTDataset] = None) -> int:
        """Train until ``max_steps`` (or ``epochs`` or an early stop); returns
        the last step. ``dataset`` defaults to ``FTDataset(data_path)``."""
        tb = self.tcfg
        if dataset is None:
            dataset = FTDataset(tb.data_path, self.sr, tb.batch_size)
        step = self.state.step
        d = tb.ema_decay
        t0 = time.time()
        for epoch in range(tb.epochs):
            # each batch's numpy generator derives from (seed, step), so
            # prefetched batches abandoned by a stop cannot shift the stream
            prep_step = iter(range(step, step + 10 ** 9))

            def _prep(batch, _steps=prep_step):
                s = next(_steps)
                t = time.perf_counter()
                feats = self.prepare_batch(batch, np.random.default_rng((tb.seed, s)), step=s)
                return feats, time.perf_counter() - t

            waits: list = []
            for feats, prep_s in prefetched(
                    dataset.batches(shuffle=True, epoch=epoch), _prep, depth=tb.prefetch,
                    waits=waits):
                before = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                          attention.DIT_ATTENTION_LAUNCHES)
                self.state, metrics = self.step_fn(self.state, feats, (tb.seed, step),
                                                   local_rows=True)
                step += 1
                after = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                         attention.DIT_ATTENTION_LAUNCHES)
                loss = metrics["loss"]
                self.history.append({
                    "step": step, "T": int(feats["mels"].shape[1]), "prep_s": prep_s,
                    "wait_s": waits[-1], "end": time.perf_counter(), "span": metrics["span"],
                    "loss": loss, "grad_norm": metrics["grad_norm"],
                    **{k: a - b for k, a, b in zip(("k1", "k1b", "k3"), after, before)}})
                self._ema_dev = (loss if self._ema_dev is None
                                 else d * self._ema_dev + (1 - d) * loss)
                if step % tb.log_interval == 0:
                    self.ema_loss = float(self._ema_dev)
                    print(f"step {step} loss {float(loss):.4f} ema {self.ema_loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} "
                          f"({(time.time() - t0) / tb.log_interval:.2f}s/step)", flush=True)
                    t0 = time.time()
                    if self.ema_loss < self.best_ema - 1e-4:
                        self.best_ema = self.ema_loss
                        self.plateau_count = 0
                    else:
                        self.plateau_count += 1
                        if self.plateau_count >= tb.lr_halve_patience:
                            self.halve_lr()
                            self.plateau_count = 0
                if val_dataset is not None and tb.validation_interval \
                        and step % tb.validation_interval == 0:
                    val_loss = self.validate(val_dataset)
                    if val_loss < self.best_val_loss - 1e-4:
                        self.best_val_loss = val_loss
                        self.val_patience = 0
                    else:
                        self.val_patience += 1
                    print(f"step {step} val_loss {val_loss:.4f} (best {self.best_val_loss:.4f}, "
                          f"patience {self.val_patience})", flush=True)
                    if self.val_patience >= tb.early_stop_patience:
                        print("early stop: validation plateau", flush=True)
                        return self._finish(step)
                if step % tb.save_interval == 0:
                    self.save(step)
                if step >= tb.max_steps:
                    return self._finish(step)
        return self._finish(step)

    def _finish(self, step: int) -> int:
        if self._ema_dev is not None:
            self.ema_loss = float(self._ema_dev)
        self.save(step)
        return step
