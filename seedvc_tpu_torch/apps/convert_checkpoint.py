"""Convert published torch checkpoints into flax-layout parameter trees (port
of ``seedvc_tpu/apps/convert_checkpoint.py``: the same flags, file names and
trees, bit for bit).

The reference auto-downloads checkpoints from HF (``hf_utils.py``); this CLI
takes local files (``core/hub.py::MODEL_ZOO`` names them):

    python -m seedvc_tpu_torch.apps.convert_checkpoint --out ./checkpoints \
        --preset whisper_small_wavenet \
        --dit DiT_seed_v2_uvit_whisper_small_wavenet_bigvgan_pruned.pth \
        --campplus campplus_cn_common.bin \
        --bigvgan bigvgan_generator.pt \
        --whisper /path/to/openai-whisper-small \
        --rmvpe rmvpe.pt --hift hift.pt

Each converted tree is written as ``<out>/<name>.pkl`` and loads via
``--checkpoint-dir`` in the inference CLIs (``apps.infer``, ``apps.infer_v2``,
``apps.webui``, ...). It runs on the host alone and needs torch and numpy:
``.safetensors`` files are read by ``convert.torch_utils.load_safetensors``.
"""

from __future__ import annotations

import argparse
import os
import pickle


def _save(out_dir: str, name: str, tree) -> None:
    path = os.path.join(out_dir, f"{name}.pkl")
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    print(f"wrote {path}")


def _load_state_dict(path: str) -> dict:
    """A state dict from a ``.safetensors`` file or a ``torch.save`` file."""
    import torch

    from seedvc_tpu_torch.convert.torch_utils import load_safetensors

    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--preset", default="whisper_small_wavenet")
    ap.add_argument("--dit", help="v1 DiT checkpoint (.pth)")
    ap.add_argument("--campplus", help="campplus_cn_common.bin")
    ap.add_argument("--bigvgan", help="bigvgan_generator.pt")
    ap.add_argument("--whisper", help="HF whisper model dir or .bin")
    ap.add_argument("--rmvpe", help="rmvpe.pt")
    ap.add_argument("--hift", help="hift.pt (CosyVoice)")
    ap.add_argument("--astral-narrow", help="ASTRAL bsq32 checkpoint (v2)")
    ap.add_argument("--astral-wide", help="ASTRAL bsq2048 checkpoint (v2)")
    ap.add_argument("--v2-cfm", help="v2 CFM checkpoint (cfm_small.pth: "
                                     "{'net': {'cfm', 'length_regulator'}})")
    ap.add_argument("--v2-ar", help="v2 AR checkpoint (ar_base.pth: "
                                    "{'net': {'ar', 'length_regulator'}})")
    ap.add_argument("--hubert", help="HF hubert-large dir (v2 SSL)")
    ap.add_argument("--openvoice", help="OpenVoiceV2 converter checkpoint.pth")
    ap.add_argument("--wavlm-sv", help="microsoft/wavlm-base-plus-sv dir or "
                                       ".bin (SECS extractor, eval harness)")
    ap.add_argument("--use-ema", action="store_true",
                    help="load EMA weights from the DiT checkpoint")
    args = ap.parse_args(argv)

    import torch

    from seedvc_tpu_torch.core.config import get_preset

    cfg = get_preset(args.preset)
    os.makedirs(args.out, exist_ok=True)

    if args.dit:
        from seedvc_tpu_torch.convert.dit import convert_vc_checkpoint

        ckpt = torch.load(args.dit, map_location="cpu", weights_only=False)
        net = ckpt.get("net", ckpt)
        if args.use_ema and "ema" in ckpt:
            # EMA weights are stored positionally, aligned with the param
            # order minus 'input_pos' buffers (modules/commons.py:423-432).
            for key in net:
                names = [n for n in net[key] if "input_pos" not in n]
                for n, t in zip(names, ckpt["ema"][key][0]):
                    net[key][n] = t
        _save(args.out, "vc", convert_vc_checkpoint({"net": net},
                                                    cfg.model_params))

    if args.campplus:
        from seedvc_tpu_torch.convert.campplus import convert_campplus

        sd = torch.load(args.campplus, map_location="cpu", weights_only=False)
        _save(args.out, "campplus", convert_campplus(sd))

    if args.bigvgan:
        from seedvc_tpu_torch.convert.bigvgan import convert_bigvgan
        from seedvc_tpu_torch.models.bigvgan import BIGVGAN_22K_80, BIGVGAN_44K_128

        sd = torch.load(args.bigvgan, map_location="cpu", weights_only=False)
        voc_cfg = (BIGVGAN_44K_128
                   if cfg.preprocess_params.spect_params.n_mels == 128
                   else BIGVGAN_22K_80)
        _save(args.out, "vocoder", convert_bigvgan(sd, voc_cfg))

    if args.whisper:
        from seedvc_tpu_torch.convert.whisper import convert_whisper_encoder

        path = args.whisper
        if os.path.isdir(path):
            candidates = [os.path.join(path, n) for n in
                          ("pytorch_model.bin", "model.safetensors")]
            path = next(p for p in candidates if os.path.exists(p))
        sd = _load_state_dict(path)
        sd = {k.replace("model.encoder.", "encoder."): v for k, v in sd.items()}
        n_layers = 12  # whisper-small
        _save(args.out, "whisper", convert_whisper_encoder(sd, n_layers))

    if args.rmvpe:
        from seedvc_tpu_torch.convert.rmvpe import convert_rmvpe

        sd = torch.load(args.rmvpe, map_location="cpu", weights_only=False)
        _save(args.out, "rmvpe", convert_rmvpe(sd))

    if args.hift:
        from seedvc_tpu_torch.convert.hifigan import convert_hift

        sd = torch.load(args.hift, map_location="cpu", weights_only=False)
        _save(args.out, "vocoder", convert_hift(sd))

    for flag, name in (("astral_narrow", "narrow"), ("astral_wide", "wide")):
        path = getattr(args, flag)
        if path:
            from seedvc_tpu_torch.convert.astral import convert_astral

            sd = torch.load(path, map_location="cpu", weights_only=False)
            _save(args.out, name, convert_astral(sd))

    if args.v2_cfm:
        # v2 CFM checkpoint -> dit.pkl + cfm_reg.pkl (VoiceConverterV2
        # PARAM_NAMES); structure per modules/v2/vc_wrapper.py:259-268
        from seedvc_tpu_torch.convert.dit_v2 import (convert_dit_v2,
                                               convert_regulator_v2)
        from seedvc_tpu_torch.core.config import LengthRegulatorConfig
        from seedvc_tpu_torch.pipelines.convert_v2 import V2Config

        vcfg = V2Config()
        ckpt = torch.load(args.v2_cfm, map_location="cpu", weights_only=False)
        net = ckpt.get("net", ckpt)
        _save(args.out, "dit", convert_dit_v2(net["cfm"], vcfg.dit))
        _save(args.out, "cfm_reg", convert_regulator_v2(
            net["length_regulator"],
            LengthRegulatorConfig(channels=vcfg.dit.content_dim,
                                  is_discrete=True,
                                  content_codebook_size=vcfg.wide.codebook_size,
                                  sampling_ratios=(1, 1, 1, 1))))

    if args.v2_ar:
        from seedvc_tpu_torch.convert.ar import convert_ar
        from seedvc_tpu_torch.convert.dit_v2 import convert_regulator_v2
        from seedvc_tpu_torch.core.config import LengthRegulatorConfig
        from seedvc_tpu_torch.pipelines.convert_v2 import V2Config

        vcfg = V2Config()
        ckpt = torch.load(args.v2_ar, map_location="cpu", weights_only=False)
        net = ckpt.get("net", ckpt)
        _save(args.out, "ar", convert_ar(net["ar"], vcfg.ar.n_layer))
        _save(args.out, "ar_reg", convert_regulator_v2(
            net["length_regulator"],
            LengthRegulatorConfig(channels=vcfg.ar.dim, is_discrete=True,
                                  content_codebook_size=vcfg.narrow.codebook_size,
                                  sampling_ratios=())))

    if args.hubert:
        from seedvc_tpu_torch.convert.ssl import convert_ssl

        path = args.hubert
        if os.path.isdir(path):
            candidates = [os.path.join(path, n) for n in
                          ("pytorch_model.bin", "model.safetensors")]
            path = next(p for p in candidates if os.path.exists(p))
        sd = _load_state_dict(path)
        _save(args.out, "ssl", convert_ssl(sd, n_layers=18))

    if args.openvoice:
        from seedvc_tpu_torch.convert.openvoice import convert_openvoice

        sd = torch.load(args.openvoice, map_location="cpu", weights_only=False)
        _save(args.out, "openvoice", convert_openvoice(sd))

    if args.wavlm_sv:
        from seedvc_tpu_torch.convert.wavlm_sv import convert_wavlm_sv

        path = args.wavlm_sv
        if os.path.isdir(path):
            candidates = [os.path.join(path, n) for n in
                          ("pytorch_model.bin", "model.safetensors")]
            path = next(p for p in candidates if os.path.exists(p))
        sd = _load_state_dict(path)
        _save(args.out, "wavlm_sv", convert_wavlm_sv(sd))


if __name__ == "__main__":
    main()
