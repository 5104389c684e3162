"""``seedvc_tpu_torch.core.hub`` (port of ``seedvc_tpu/core/hub.py``): the
JAX package's four hub tests in tests/test_apps_frontends.py on the port,
the registries equal to JAX's, and the download path. No test reaches the
network: every file comes from the cache directory, and ``_download`` is
replaced where a test could fall through to it."""

import dataclasses
import sys

import pytest

from seedvc_tpu_torch.core import hub


@pytest.fixture
def no_network(monkeypatch):
    def refuse(repo_id, filename, cache_dir):
        raise AssertionError(f"tried to download {repo_id}/{filename}")

    monkeypatch.setattr(hub, "_download", refuse)


def test_zoo_presets_reference_known_artifacts():
    for preset, names in hub.PRESET_ARTIFACTS.items():
        for name in names:
            assert name in hub.MODEL_ZOO, (preset, name)
    # coordinates of the flagship checkpoint (reference inference.py:49-52)
    art = hub.MODEL_ZOO["dit_whisper_small_wavenet"]
    assert art.repo_id == "Plachta/Seed-VC"
    assert art.filename.endswith(".pth")
    assert art.config_filename.endswith(".yml")


def test_zoo_and_presets_equal_jax():
    from seedvc_tpu.core import hub as jax_hub

    assert {k: dataclasses.astuple(v) for k, v in hub.MODEL_ZOO.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_hub.MODEL_ZOO.items()}
    assert hub.PRESET_ARTIFACTS == jax_hub.PRESET_ARTIFACTS
    assert hub.DEFAULT_CACHE_DIR == jax_hub.DEFAULT_CACHE_DIR


def test_hub_local_path_short_circuits_network(tmp_path, no_network):
    (tmp_path / "rmvpe.pt").write_bytes(b"x")
    path = hub.load_custom_model_from_hf("lj1995/VoiceConversionWebUI", "rmvpe.pt",
                                         cache_dir=str(tmp_path))
    assert path == str(tmp_path / "rmvpe.pt")


def test_hub_nested_filename_and_config(tmp_path, no_network):
    # flat layout by basename (manually dropped file)
    (tmp_path / "cfm_small.pth").write_bytes(b"x")
    (tmp_path / "config.yml").write_bytes(b"y")
    m, c = hub.load_custom_model_from_hf("Plachta/Seed-VC", "v2/cfm_small.pth", "config.yml",
                                         cache_dir=str(tmp_path))
    assert m.endswith("cfm_small.pth") and c.endswith("config.yml")


def test_hub_unknown_artifact_raises():
    with pytest.raises(KeyError):
        hub.fetch("nonexistent_model")
    with pytest.raises(KeyError):
        hub.fetch_preset("nonexistent_preset")


def test_fetch_preset_from_the_hub_cache_layout(tmp_path, no_network):
    """Every artifact of a preset found in huggingface_hub's cache layout
    (``models--org--repo/snapshots/<rev>/<file>``), config sidecars too."""
    for name in hub.PRESET_ARTIFACTS["whisper_small_wavenet"]:
        art = hub.MODEL_ZOO[name]
        snap = tmp_path / ("models--" + art.repo_id.replace("/", "--")) / "snapshots" / "abc"
        for filename in filter(None, (art.filename, art.config_filename)):
            (snap / filename).parent.mkdir(parents=True, exist_ok=True)
            (snap / filename).write_bytes(b"x")
    got = hub.fetch_preset("whisper_small_wavenet", cache_dir=str(tmp_path))
    assert sorted(got) == sorted(hub.PRESET_ARTIFACTS["whisper_small_wavenet"])
    model, config = got["dit_whisper_small_wavenet"]
    assert "snapshots" in model and model.endswith(".pth") and config.endswith(".yml")
    assert got["campplus"].endswith("campplus_cn_common.bin")


def test_download_without_huggingface_hub_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is not installed"):
        hub.fetch("rmvpe", cache_dir=str(tmp_path))
