"""``apps.train`` and ``apps.train_v2`` across 2 gloo ranks on the CPU, as
a launcher would start them (the process group up before ``main``): 2 steps
with ``--n-model 2`` (tensor parallel) and with ``--fsdp`` (data parallel
and FSDP) each, on tiny configs (``tests/test_torch_trainer_cli.py``'s and
``tests/test_trainer_v2.py``'s): every step's loss finite, the mesh laid
out as the flags ask, the coordinator's checkpoint at step 2 and the v1
export written."""

import math
import os

from test_torch_trainer_cli import CFG, WHISPER
from test_trainer_v2 import tiny_v2cfg
from torch_parallel_worker import spawn
from torch_port_helpers import trainer_wav_dir, v2_port_cfg


def test_train_clis_on_two_ranks(tmp_path):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    trainer_wav_dir(wav_dir)
    flags = [["--n-model", "2"], ["--fsdp"]]
    out = spawn("cli", 2, tmp_path, dict(cfg=CFG, whisper=WHISPER, vcfg=v2_port_cfg(tiny_v2cfg()),
                                         wav_dir=str(wav_dir), cwd=str(tmp_path), flags=flags),
                timeout=150)
    assert out["n-model_2"]["mesh"] == {"data": 1, "model": 2}
    assert out["fsdp"]["mesh"] == {"data": 2, "model": 1}
    for name, run in out.items():
        for kind in ("v1", "v2"):
            assert run[f"{kind}_step"] == 2, (name, kind)
            assert len(run[kind]) == 2 and all(math.isfinite(x) for x in run[kind]), (name, kind)
            assert os.path.exists(tmp_path / f"runs/{kind}_{name}/ckpt_00000002.pt")
        assert os.path.exists(tmp_path / f"x_{name}/vc.pkl")
