"""v2 fine-tuning on one GPU: joint AR (cross-entropy) + CFM (flow matching)
(port of ``seedvc_tpu/train/trainer_v2.py``).

- frozen encoders: the SSL trunk (HuBERT-large cut at layer 18) and both
  ASTRAL quantizers give the content tokens (narrow: the AR's source, wide:
  the CFM's condition and the AR's target), CAMPPlus the style; all f32;
- the trainable unit ``V2Modules`` = {``dit``, ``cfm_reg``, ``ar``,
  ``ar_reg``} in f32, selected by ``train_cfm`` / ``train_ar``: a branch left
  out is not run and is frozen (no update, no weight decay, no moments);
  one clip by the global norm over every module (``make_v2_optimizer``);
- ``prepare_batch``: the mel and its -10 pad on the device in ``mel_bucket``
  buckets; the 16 kHz batch in 5 s buckets for the SSL pass and the style;
  ``token_lens = len16 // 320`` in ``token_bucket`` buckets, the wide
  indices zeroed past them; the narrow indices come to the host for the
  duration reduction of the AR's condition;
- the step: the CFM loss (prompt of ``frac * 0.5`` of each mel, whole-batch
  CFG dropout: one draw for the prompt, and the content dropped only with
  it) plus the AR loss, optionally distilled against a frozen teacher on the
  same draws (``0.5 (cfm - t_cfm)^2 + 0.3 (ar - t_ar)^2``), then the
  optimizer;
- the draws of a step (:class:`TrainDrawsV2`) come from a ``torch.Generator``
  seeded from the step key ``(seed, step)``, and a validation batch's from
  ``(seed + i,)``; ``draws_fn`` replaces them (the parity tests replay JAX's);
- ``train``: batches prepared ``prefetch`` ahead on a worker thread,
  logging, validation with patience early stop, checkpoints in the port's
  ``torch.save`` format under ``run_dir`` (newest two, one a step).

In the DiT's trunk the attention takes K1 forward and K1ᵇ backward (13 of
each a step at full width, at T = mel bucket + 2), in f32. Where a batch's
longest 16 kHz clip ends within 320 samples of a 5 s bucket, its token count
exceeds the SSL frames; the regulator's ``x_lens`` is held to the frames
there (the JAX trainer gathers past them).

Device: ``cuda`` unless the caller passes ``device="cpu"``; without a card the
constructor raises. On cuda TF32 is turned off (cuDNN and matmuls): the step
is specified in f32.

Several GPUs, as the v1 trainer (``train/trainer.py``): a (data, model) mesh
over the process group with ``n_data = world_size // n_model``; the DiT's and
the AR's attention and the DiT's FFN split over ``model``, FSDP2 over
``data`` with ``fsdp`` (the constructor's ``fsdp_min_elems``); each rank prepares and steps on its rows of the
batch, with the whole batch's sizes and draws (the whole-batch prompt and
content drops are one draw on every rank). The CFM loss is the mean over
ranks of the ranks' means, the AR loss the mean over every rank's valid
labels, so a step on any mesh is the one-process step on the same batch.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from seedvc_tpu_torch.core.config import LengthRegulatorConfig, SpectConfig
from seedvc_tpu_torch.dsp.mel import MelFrontend
from seedvc_tpu_torch.models.ar import ARTransformer
from seedvc_tpu_torch.models.ar_train import ar_loss
from seedvc_tpu_torch.models.astral import AstralQuantizer
from seedvc_tpu_torch.models.campplus import CAMPPlus
from seedvc_tpu_torch.models.cfm_v2 import cfm_v2_loss
from seedvc_tpu_torch.models.dit_v2 import DiTV2
from seedvc_tpu_torch.models.regulator import InterpolateRegulator
from seedvc_tpu_torch.models.ssl import SSLEncoder
from seedvc_tpu_torch.nn.bsq import duration_reduction
from seedvc_tpu_torch.ops import attention
from seedvc_tpu_torch.parallel.collectives import all_reduce_max, pmean
from seedvc_tpu_torch.parallel.mesh import AXES, data_rows, set_mesh
from seedvc_tpu_torch.parallel.sharding import WHOLE, Layout
from seedvc_tpu_torch.pipelines.convert_v2 import V2Config
from seedvc_tpu_torch.train.dataset import Batch
from seedvc_tpu_torch.train.optim import (OptState, apply_updates, global_norm,
                                          make_v2_optimizer, warmup_cosine)
from seedvc_tpu_torch.train.prefetch import prefetched
from seedvc_tpu_torch.train.step import average_gradients, draw_rows, shard_model, step_seed
from seedvc_tpu_torch.train.trainer import (agree, batch_style, checkpoint_paths, data_mesh,
                                            latest_checkpoint, load_state, padded_mel,
                                            save_state, to_device)
from seedvc_tpu_torch.weights import load_jax_params

SSL_BUCKET = 5 * 16000  # 16 kHz samples
TOKEN_HOP = 320         # 16 kHz samples a content token


@dataclass
class TrainerV2Config:
    batch_size: int = 2
    max_steps: int = 1000
    epochs: int = 1000
    base_lr: float = 1e-4
    warmup_steps: int = 100
    grad_clip: float = 1000.0
    train_ar: bool = True
    train_cfm: bool = True
    distill_ar: bool = False     # loss-level distillation weights against the teacher
    distill_cfm: bool = False
    mel_bucket: int = 128
    token_bucket: int = 64
    seed: int = 1234
    run_dir: Optional[str] = None  # checkpoints when set
    save_interval: int = 500
    log_interval: int = 10
    validation_interval: int = 0  # steps between validate() (0 = off)
    val_batches: int = 4          # batches averaged per validation
    early_stop_patience: int = 10  # validations without improvement -> stop
    fsdp: bool = False            # scatter params / AdamW moments over the data axis
    prefetch: int = 2             # batches prepared ahead on a worker thread; 0 = off


class V2TrainState(NamedTuple):
    """``params``: name -> the trainable modules' own parameters (updated in
    place); ``opt_state``; ``step`` (Python int); ``layout``: where each
    lives on the mesh (by default every tensor whole, one process)."""

    params: dict
    opt_state: OptState
    step: int
    layout: Layout = WHOLE


class TrainDrawsV2(NamedTuple):
    """A step's draws: ``frac`` (B,) uniform (the prompt fractions),
    ``prompt_drop`` and ``content_drop`` () bool (whole-batch CFG dropout;
    content only with the prompt), ``t`` (B,) uniform, ``noise`` (B, T, C)
    normal."""

    frac: torch.Tensor
    prompt_drop: torch.Tensor
    content_drop: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor


DrawsFn = Callable[[tuple, tuple, torch.device], TrainDrawsV2]


def draw_train_v2(g: torch.Generator, B: int, T: int, n_mels: int, class_dropout_prob: float,
                  device=None) -> TrainDrawsV2:
    frac = torch.rand(B, generator=g, device=device)
    prompt_drop = torch.rand((), generator=g, device=device) < class_dropout_prob
    content_drop = (torch.rand((), generator=g, device=device) < 0.5) & prompt_drop
    t = torch.rand(B, generator=g, device=device)
    noise = torch.randn((B, T, n_mels), generator=g, device=device)
    return TrainDrawsV2(frac, prompt_drop, content_drop, t, noise)


def generator_draws_v2(class_dropout_prob: float) -> DrawsFn:
    """The default ``draws_fn``: a generator on the batch's device seeded from
    the key, so a step's draws depend on the key alone."""
    def draws_fn(key, shape, device) -> TrainDrawsV2:
        g = torch.Generator(device=device).manual_seed(step_seed(key))
        return draw_train_v2(g, *shape, class_dropout_prob, device=device)

    return draws_fn


class V2Modules(nn.Module):
    """The trainable unit: the DiT and its regulator over the wide tokens,
    the AR and its regulator over the narrow ones. Its flax-layout tree is
    ``{"dit", "cfm_reg", "ar", "ar_reg"}``, the JAX trainer's params."""

    def __init__(self, vcfg: V2Config):
        super().__init__()
        self.dit = DiTV2(vcfg.dit)
        self.cfm_reg = InterpolateRegulator(LengthRegulatorConfig(
            channels=vcfg.dit.content_dim, is_discrete=True,
            content_codebook_size=vcfg.wide.codebook_size, sampling_ratios=(1, 1, 1, 1)))
        self.ar = ARTransformer(vcfg.ar)
        self.ar_reg = InterpolateRegulator(LengthRegulatorConfig(
            channels=vcfg.ar.dim, is_discrete=True,
            content_codebook_size=vcfg.narrow.codebook_size, sampling_ratios=()))


def _bucket(n: int, b: int) -> int:
    return -(-n // b) * b


class TrainerV2:
    def __init__(self, vcfg: V2Config, tcfg: TrainerV2Config, *,
                 frozen_params: Optional[dict] = None, n_model: int = 1,
                 teacher_params: Optional[dict] = None, device=None,
                 draws_fn: Optional[DrawsFn] = None, fsdp_min_elems: int = 65536):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainerV2: no CUDA device; pass device='cpu' to train on the CPU")
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.vcfg, self.tcfg = vcfg, tcfg
        self.mesh = data_mesh(n_model, tcfg.batch_size, self.device)
        self._n_data = self.mesh.size(AXES.data)
        self._prep_group = self.mesh.fresh_group(AXES.data)  # the prefetch thread's
        self.mel_fn = MelFrontend(vcfg.sr, SpectConfig(n_mels=vcfg.n_mels))
        frozen_params = frozen_params or {}
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(tcfg.seed)
            frozen = {"ssl": SSLEncoder(vcfg.ssl), "narrow": AstralQuantizer(vcfg.narrow),
                      "wide": AstralQuantizer(vcfg.wide),
                      "campplus": CAMPPlus(feat_dim=80,
                                           embedding_size=vcfg.dit.style_encoder_dim)}
            self.model = V2Modules(vcfg)
        for name, module in frozen.items():
            if frozen_params.get(name) is not None:
                load_jax_params(module, frozen_params[name])
            setattr(self, name, module.requires_grad_(False).eval().to(self.device))
        self.model.to(self.device).train()
        self.teacher = None
        if teacher_params is not None:
            self.teacher = load_jax_params(V2Modules(vcfg), teacher_params)
            self.teacher.requires_grad_(False).eval().to(self.device)
        self.draws_fn = draws_fn or generator_draws_v2(vcfg.dit.class_dropout_prob)

        schedule = warmup_cosine(tcfg.base_lr, tcfg.warmup_steps, tcfg.max_steps)
        self.optimizer = make_v2_optimizer(schedule, train_cfm=tcfg.train_cfm,
                                           train_ar=tcfg.train_ar, grad_clip=tcfg.grad_clip)
        layout = shard_model(self.model, self.mesh, tcfg.fsdp, fsdp_min_elems)
        params = dict(self.model.named_parameters())
        self.state = V2TrainState(params, self.optimizer.init(params), 0, layout)
        self.best_val_loss = float("inf")
        self.patience_counter = 0
        # one record a step: step, mel frames T, host seconds of its prepare,
        # host time at its end, loss and grad norm (device tensors) and the
        # attention launches it made
        self.history: list[dict] = []

    # ------------------------------------------------------------------
    def _put(self, x: np.ndarray) -> torch.Tensor:
        return to_device(x, self.device)

    @torch.no_grad()
    def prepare_batch(self, batch: Batch) -> tuple[dict, dict]:
        """The step's inputs on the device, and its static sizes ``mel_T``,
        ``ar_C``, ``ar_X``, ``tok_T``: on a mesh with ``data`` wider than 1,
        this rank's rows of the batch, at the whole batch's sizes."""
        tc, vc = self.tcfg, self.vcfg
        B = batch.waves.shape[0]
        rows = data_rows(self.mesh, B)
        mel_lens = (batch.wave_lengths // vc.hop).astype(np.int32)
        mel_T = _bucket(int(mel_lens.max()), tc.mel_bucket)
        waves = np.zeros((B, mel_T * vc.hop), np.float32)
        n = min(waves.shape[1], batch.waves.shape[1])
        waves[:, :n] = batch.waves[:, :n]
        mel_lens_d = self._put(mel_lens[rows])
        mels = padded_mel(self.mel_fn, self._put(waves[rows]), mel_lens_d)

        # content tokens from one SSL pass over the 5 s-bucketed batch
        w16_T = _bucket(batch.waves_16k.shape[1], SSL_BUCKET)
        w16 = np.zeros((B, w16_T), np.float32)
        w16[:, :batch.waves_16k.shape[1]] = batch.waves_16k
        w16_d = self._put(w16[rows])
        token_lens = (batch.wave_16k_lengths // TOKEN_HOP).astype(np.int32)
        tok_T = _bucket(int(token_lens.max()), tc.token_bucket)
        out_T = min(tok_T, w16_T // TOKEN_HOP)
        ssl_feats = self.ssl(w16_d)
        token_lens_d = self._put(token_lens[rows])
        idx_n = self.narrow(ssl_feats)[1][:, :out_T].cpu().numpy()
        idx_w = self.wide(ssl_feats)[1]
        pos = torch.arange(idx_w.shape[1], device=idx_w.device)[None, :]
        idx_w = torch.where(pos < token_lens_d[:, None], idx_w,
                            torch.zeros_like(idx_w))[:, :out_T]

        # the AR's condition: duration-reduced narrow tokens (host, data dependent)
        local_lens = token_lens[rows]
        reduced = [duration_reduction(idx_n[b, :local_lens[b]])[0] for b in range(len(idx_n))]
        ar_cond_lens = np.array([len(r) for r in reduced], np.int32)
        # the longest over the whole batch (every rank's rows)
        cond_max = int(all_reduce_max(torch.tensor([max(int(ar_cond_lens.max()), 1)],
                                                   device=self.device), self._prep_group))
        ar_C = _bucket(cond_max, tc.token_bucket)
        ar_cond_idx = np.zeros((len(reduced), ar_C), np.int64)
        for b, r in enumerate(reduced):
            ar_cond_idx[b, :len(r)] = r

        # style from the true lengths (kaldi frames, snip_edges)
        frame_lens = np.maximum((batch.wave_16k_lengths - 400) // 160 + 1, 1).astype(np.int32)
        style = batch_style(self.campplus, w16_d, self._put(frame_lens[rows]))
        feats = {
            "mels": mels, "mel_lens": mel_lens_d, "wide_idx": idx_w, "token_lens": token_lens_d,
            "tok_max": self._put(np.asarray(min(int(token_lens.max()), idx_w.shape[1]),
                                            np.int32)),
            "ar_cond_idx": self._put(ar_cond_idx), "ar_cond_lens": self._put(ar_cond_lens),
            "ar_cond_max": self._put(np.asarray(cond_max, np.int32)),
            "style": style}
        dims = {"mel_T": mel_T, "ar_C": ar_C, "ar_X": int(idx_w.shape[1]), "tok_T": tok_T}
        return feats, dims

    # ------------------------------------------------------------------
    def _draws(self, key, feats: dict) -> TrainDrawsV2:
        """This rank's rows of the whole batch's draws."""
        mels = feats["mels"]
        B, T, C = mels.shape
        d = self.draws_fn(key, (B * self._n_data, T, C), mels.device)
        return draw_rows(TrainDrawsV2(*(t.to(mels.device) for t in d)), self.mesh,
                         B * self._n_data)

    def _losses(self, model: V2Modules, feats: dict, dims: dict, draws: TrainDrawsV2, *,
                forward_cfm: bool, forward_ar: bool) -> tuple[torch.Tensor, dict]:
        """The joint loss over the selected branches, and each branch's, of
        the whole batch (each a mean over the ``data`` ranks)."""
        with set_mesh(self.mesh, AXES.data):
            return self._losses_local(model, feats, dims, draws, forward_cfm=forward_cfm,
                                      forward_ar=forward_ar)

    def _losses_local(self, model, feats, dims, draws, *, forward_cfm, forward_ar):
        g_data = self.mesh.group(AXES.data)
        total = torch.zeros((), dtype=torch.float32, device=feats["mels"].device)
        metrics = {}
        if forward_cfm:
            mels, mel_lens = feats["mels"], feats["mel_lens"]
            # x_lens crops the bucketed tokens to the batch's true count
            cond = model.cfm_reg(feats["wide_idx"], mel_lens, dims["mel_T"],
                                 x_lens=feats["tok_max"])[0]
            B = mels.shape[0]
            prompt_lens = (draws.frac * 0.5 * mel_lens).to(torch.int32)
            pdv = draws.prompt_drop.float().expand(B)
            cdv = draws.content_drop.float().expand(B)

            def estimate(x, px, lens, t, s, m):
                return model.dit(x, px, lens, t, s, m, prompt_drop=pdv, content_drop=cdv)

            loss_cfm = pmean(cfm_v2_loss(estimate, mels, mel_lens, prompt_lens, cond,
                                         feats["style"], t=draws.t, noise=draws.noise), g_data)
            total = total + loss_cfm
            metrics["loss_cfm"] = loss_cfm
        if forward_ar:
            ar_X = dims["ar_X"]
            cond_emb = model.ar_reg(feats["ar_cond_idx"], feats["ar_cond_lens"], dims["ar_C"],
                                    x_lens=feats["ar_cond_max"])[0]
            loss_ar = pmean(ar_loss(model.ar, cond_emb, feats["ar_cond_lens"],
                                    feats["wide_idx"][:, :ar_X],
                                    torch.clamp(feats["token_lens"], max=ar_X)), g_data)
            total = total + loss_ar
            metrics["loss_ar"] = loss_ar
        return total, metrics

    def _device_step(self, feats: dict, dims: dict, key) -> dict:
        """One optimizer step on prepared features; metrics as device tensors."""
        tc, st = self.tcfg, self.state
        draws = self._draws(key, feats)
        self.model.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, metrics = self._losses(self.model, feats, dims, draws,
                                          forward_cfm=tc.train_cfm, forward_ar=tc.train_ar)
            if self.teacher is not None:
                # the same draws for the teacher: a like-for-like comparison
                cfm_on, ar_on = tc.train_cfm and tc.distill_cfm, tc.train_ar and tc.distill_ar
                with torch.no_grad():
                    _, t_metrics = self._losses(self.teacher, feats, dims, draws,
                                                forward_cfm=cfm_on, forward_ar=ar_on)
                distill = torch.zeros_like(total)
                if cfm_on:
                    distill = distill + 0.5 * (metrics["loss_cfm"] - t_metrics["loss_cfm"]) ** 2
                if ar_on:
                    distill = distill + 0.3 * (metrics["loss_ar"] - t_metrics["loss_ar"]) ** 2
                metrics["loss_distill"] = distill
                total = total + distill
            if total.requires_grad:
                total.backward()
        layout = st.layout
        names = list(st.params)
        grads = {n: st.params[n].grad for n in names}
        average_gradients(grads, layout)
        gnorm = global_norm(grads.values(), layout, names).to(total.device)
        updates, opt_state = self.optimizer.update(grads, st.opt_state, st.params, layout)
        apply_updates(st.params, updates)
        self.state = V2TrainState(st.params, opt_state, st.step + 1, layout)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=total.detach(), grad_norm=gnorm)
        return metrics

    def train_step(self, batch: Batch, key=None) -> dict:
        """Prepare ``batch`` and take one step with the draws of ``key``
        (default ``(seed, step)``); metrics as floats."""
        feats, dims = self.prepare_batch(batch)
        key = (self.tcfg.seed, self.state.step) if key is None else key
        return {k: float(v) for k, v in self._device_step(feats, dims, key).items()}

    @torch.no_grad()
    def validate(self, val_dataset) -> float:
        """Mean joint loss over up to ``val_batches`` batches, the same branch
        selection without gradients or distillation, batch i's draws from
        ``(seed + i,)``; every batch is prepared anew."""
        tc = self.tcfg
        losses = []
        for i, batch in enumerate(val_dataset.batches(shuffle=False, epoch=0)):
            if i >= tc.val_batches:
                break
            feats, dims = self.prepare_batch(batch)
            total, _ = self._losses(self.model, feats, dims, self._draws((tc.seed + i,), feats),
                                    forward_cfm=tc.train_cfm, forward_ar=tc.train_ar)
            losses.append(float(total))
        return float(np.mean(losses)) if losses else float("nan")

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        return latest_checkpoint(self.tcfg.run_dir)

    def save(self, step: int):
        """Checkpoint the trainable modules' params, the optimizer state and the
        step at ``step`` (``run_dir/ckpt_<step>.pt``) as full tensors; once a
        step, newest two kept; on a mesh the coordinator writes."""
        if not self.tcfg.run_dir or agree(self.latest_step() == step, self.mesh):
            return
        os.makedirs(self.tcfg.run_dir, exist_ok=True)
        save_state(self.tcfg.run_dir, step, self.state)

    def restore_latest(self) -> bool:
        """Load the newest checkpoint (cut to this rank's pieces); False if
        there is none."""
        latest = self.latest_step()
        if latest is None:
            return False
        tree = torch.load(checkpoint_paths(self.tcfg.run_dir)[latest], map_location=self.device,
                          weights_only=True)
        st = self.state
        opt, step = load_state(tree, st)
        self.state = V2TrainState(st.params, opt, step, st.layout)
        return True

    # ------------------------------------------------------------------
    def train(self, dataset, val_dataset=None) -> int:
        """The epoch loop with logging, checkpoints, validation and patience
        early stop; returns the last step."""
        tc = self.tcfg
        step = start_step = self.state.step
        t0 = time.time()

        def _prep(batch):
            t = time.perf_counter()
            feats, dims = self.prepare_batch(batch)
            return feats, dims, time.perf_counter() - t

        for epoch in range(tc.epochs):
            for feats, dims, prep_s in prefetched(dataset.batches(shuffle=True, epoch=epoch),
                                                  _prep, depth=tc.prefetch):
                before = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                          attention.DIT_ATTENTION_LAUNCHES)
                metrics = self._device_step(feats, dims, (tc.seed, step))
                step += 1
                after = (attention.LAUNCHES, attention.BWD_LAUNCHES,
                         attention.DIT_ATTENTION_LAUNCHES)
                self.history.append({
                    "step": step, "T": dims["mel_T"], "prep_s": prep_s,
                    "end": time.perf_counter(), "loss": metrics["loss"],
                    "grad_norm": metrics["grad_norm"],
                    **{k: a - b for k, a, b in zip(("k1", "k1b", "k3"), after, before)}})
                if step % tc.log_interval == 0:
                    parts = " ".join(f"{k} {float(v):.4f}" for k, v in sorted(metrics.items()))
                    print(f"step {step} {parts} "
                          f"({(time.time() - t0) / (step - start_step):.2f}s/step)", flush=True)
                if (val_dataset is not None and tc.validation_interval
                        and step % tc.validation_interval == 0):
                    val_loss = self.validate(val_dataset)
                    if val_loss < self.best_val_loss:
                        self.best_val_loss = val_loss
                        self.patience_counter = 0
                        print(f"step {step} val_loss {val_loss:.4f} (improved)", flush=True)
                    else:
                        self.patience_counter += 1
                        print(f"step {step} val_loss {val_loss:.4f} (no improvement, patience "
                              f"{self.patience_counter}/{tc.early_stop_patience})", flush=True)
                        if self.patience_counter >= tc.early_stop_patience:
                            print("early stop: validation plateau", flush=True)
                            self.save(step)
                            return step
                if step % tc.save_interval == 0:
                    self.save(step)
                if step >= tc.max_steps:
                    self.save(step)
                    return step
        self.save(step)
        return step
