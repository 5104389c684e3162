"""The comparison that decides ``correct`` fails what it must: the control
(the reference at fp8 where the configuration states bf16), and a run whose
timed path is broken underneath (the harness's look for a card skipped:
``--device cpu``)."""

import json

import numpy as np
import pytest

from vcbench import run as vrun, spec

from conftest import REPO, tiny_checkout

PIPE = {"tiny.offline": "convert", "tiny.stream": "streaming"}
CHECK = {"tiny.offline": "wave_rel_err",
         "tiny.stream": "block_rel_err"}


def _altered_answer(monkeypatch, pipe):
    """The answer altered where it is produced: the vocoded wave (v1), the
    block program's output span (stream)."""
    if pipe == "convert":
        from seedvc_tpu_torch.pipelines.convert import VoiceConverter
        orig = VoiceConverter._sample_vocode
        monkeypatch.setattr(VoiceConverter, "_sample_vocode",
                            lambda self, *a, **k: orig(self, *a, **k) * 1.05)
    else:
        from seedvc_tpu_torch.pipelines.streaming import StreamingConverter
        orig = StreamingConverter._step

        def step(self):
            orig(self)
            self._buf["out"].mul_(1.05)
        monkeypatch.setattr(StreamingConverter, "_step", step)


def _state_unchanged(monkeypatch, pipe):
    """Every Euler step returns the sampler's state unchanged."""
    monkeypatch.setattr(f"seedvc_tpu_torch.pipelines.{pipe}.euler_solve",
                        lambda estimate, noise, mu, *a, **k: noise)


def _half_batch(monkeypatch, pipe):
    """The null half of the CFG batch left out."""
    from seedvc_tpu_torch.models import cfm

    def solve(*a, **k):
        k["cfg_rate"] = 0.0
        return cfm.euler_solve(*a, **k)
    monkeypatch.setattr(f"seedvc_tpu_torch.pipelines.{pipe}.euler_solve", solve)


def _run_broken(root, cell, capsys) -> dict:
    """One run of ``cell`` on the CPU; its line, whose ``correct`` is false.
    A fine-tuning window gets 4 s, so that it holds the three steps it
    compares on a loaded CPU too."""
    seconds = "4" if cell == "tiny.train" else "1.5"
    rc = vrun.main(["--workload", cell, "--seed", "11", "--seconds", seconds, "--trace", "0",
                    "--device", "cpu"], root=root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False
    return line


@pytest.mark.parametrize("fault", [_altered_answer, _state_unchanged, _half_batch])
@pytest.mark.parametrize("cell", ["tiny.offline", "tiny.stream"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, capsys, fault, cell):
    root = tiny_checkout(tmp_path)
    fault(monkeypatch, PIPE[cell])
    check = _run_broken(root, cell, capsys)["checks"][CHECK[cell]]
    assert check["value"] > check["limit"]


def _train_state_unchanged(monkeypatch):
    """The step returns the parameters as they were."""
    monkeypatch.setattr("seedvc_tpu_torch.train.step.apply_updates", lambda p, u: None)
    return "change_leaf_gap"


def _train_half_batch(monkeypatch):
    """The loss over half the batch, the mean over the rest."""
    from seedvc_tpu_torch.models.vc import VCModel
    orig = VCModel.forward

    def forward(self, s_alt, s_ori, mels, mel_lens, style, draws, **kw):
        half = lambda x: x[:1] if x is not None and x.dim() > 0 else x  # noqa: E731
        draws = type(draws)(*(half(d) for d in draws))
        return orig(self, s_alt[:1], s_ori[:1], mels[:1], mel_lens[:1], style[:1], draws,
                    **kw)
    monkeypatch.setattr(VCModel, "forward", forward)
    return "loss_rel_gap"


def _train_altered_gradient(monkeypatch):
    """The gradient altered where it is produced, before the optimizer."""
    from seedvc_tpu_torch.train import optim
    orig = optim.Optimizer.update

    def update(self, grads, *a, **k):
        return orig(self, {n: (g * 1.05 if g is not None else g) for n, g in grads.items()},
                    *a, **k)
    monkeypatch.setattr(optim.Optimizer, "update", update)
    return "grad_leaf_gap"


@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch,
                                   _train_altered_gradient])
def test_a_broken_train_step_is_not_correct(tmp_path, monkeypatch, capsys, fault):
    root = tiny_checkout(tmp_path)
    name = fault(monkeypatch)
    check = _run_broken(root, "tiny.train", capsys)["checks"][name]
    assert check["value"] != "inf" and check["value"] > check["limit"]


def _stream_sola_offset_wrong(monkeypatch):
    """SOLA's offset always at the far end of its search."""
    monkeypatch.setattr("seedvc_tpu_torch.pipelines.streaming.sola_offset",
                        lambda chunk, buf, search: search)


def _stream_fade_skipped(monkeypatch):
    """The tail butted against the new block, no crossfade."""
    monkeypatch.setattr("seedvc_tpu_torch.pipelines.streaming.crossfade_add",
                        lambda chunk, tail: np.ascontiguousarray(chunk, np.float32))


@pytest.mark.parametrize("fault", [_stream_sola_offset_wrong, _stream_fade_skipped])
def test_a_broken_stream_join_is_not_correct(tmp_path, monkeypatch, capsys, fault):
    root = tiny_checkout(tmp_path)
    fault(monkeypatch)
    check = _run_broken(root, "tiny.stream", capsys)["checks"]["join_rel_err"]
    assert check["value"] > check["limit"]


def test_a_wrong_feature_cache_row_is_not_correct(tmp_path, monkeypatch, capsys):
    """On a feature-cache hit (every step of the window) the batch's content
    and style rows come back in the wrong order: each clip trains on the
    other's features."""
    from seedvc_tpu_torch.train.trainer import Trainer
    orig = Trainer.prepare_batch

    def prepare_batch(self, batch, *a, **k):
        hit = all(int(i) in self._feat_cache for i in batch.ids)
        feats = orig(self, batch, *a, **k)
        if hit:
            for k in ("s_alt", "s_ori", "style"):
                feats[k] = feats[k].flip(0)
        return feats
    monkeypatch.setattr(Trainer, "prepare_batch", prepare_batch)
    checks = _run_broken(tiny_checkout(tmp_path), "tiny.train", capsys)["checks"]
    assert all(c["value"] != "inf" for c in checks.values())
    assert any(c["value"] > c["limit"] for c in checks.values())


CHECKS = {"offline": ["wave_rel_err"], "stream": ["block_rel_err"],
          "train": ["feat_rel_gap", "loss_rel_gap", "grad_leaf_gap", "change_leaf_gap"]}


def _control_fails(root, workload, seed, device, capsys) -> bool:
    """Run the control in the program's place for one seed (``calibrate``)
    and say whether it fails one of the cell's numbers."""
    import os
    from vcbench import calibrate
    cwd = os.getcwd()
    os.chdir(root)
    try:
        calibrate.main(["--workload", workload, "--seeds", "", "--control-seeds", str(seed),
                        "--device", device])
    finally:
        os.chdir(cwd)
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    ctrl = next(r for r in rows if r.get("side") == "control")
    traffic = spec.load_cell(root, workload).traffic
    limits = traffic["check"]["limit"]
    return any(ctrl[k] > limits[k] for k in CHECKS[traffic["driver"]])


@pytest.mark.parametrize("cell", ["tiny.offline", "tiny.stream", "tiny.train"])
def test_the_control_fails_the_tiny_cells(tmp_path, capsys, cell):
    assert _control_fails(tiny_checkout(tmp_path), cell, 5, "cpu", capsys)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["v1_offline", "rt_stream", "v1_finetune"])
def test_the_control_fails_each_cell_at_its_size(cuda, capsys, workload):
    assert _control_fails(REPO, workload, 101, "cuda", capsys)
