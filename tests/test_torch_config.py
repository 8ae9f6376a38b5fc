"""The port's ``core/config.py`` against the JAX package's: the repo's
``config.yml`` and ``automation_config.yml`` resolve to the same dicts, the
sweep's merges agree, interpolation errors and the save round trip."""

import os

import pytest
import yaml

from gpt2_image_captioning_tpu.core import config as JCFG
from gpt2_image_captioning_tpu_torch.core import config as TCFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["config.yml", "automation_config.yml"])
def test_repo_configs_resolve_as_jax(name):
    path = os.path.join(REPO, name)
    got, want = TCFG.load_config(path), JCFG.load_config(path)
    assert got.to_dict(resolve=True) == want.to_dict(resolve=True)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("run_id", [1, 2, 18, 19])
def test_sweep_merges_match_jax(run_id):
    """Each id of automation_config.yml merged onto config.yml, as the sweep
    merges it, resolves to the JAX package's merge."""
    base_t = TCFG.load_config(os.path.join(REPO, "config.yml"))
    base_j = JCFG.load_config(os.path.join(REPO, "config.yml"))
    auto = yaml.safe_load(open(os.path.join(REPO, "automation_config.yml")))
    overrides = dict(auto["model"][run_id])
    overrides.pop("description")
    got = TCFG.update_cfg(base_t, overrides)
    want = JCFG.update_cfg(base_j, overrides)
    assert got.to_dict(resolve=True) == want.to_dict(resolve=True)
    assert base_t.to_dict() == base_j.to_dict()  # the bases are untouched


def test_interpolation_sees_overrides():
    raw = {"paths": {"data_dir": "a/", "emb": "${paths.data_dir}emb/"}, "x": {"y": 1}}
    for mod in (TCFG, JCFG):
        merged = mod.update_cfg(mod.Config(raw), {"paths": {"data_dir": "b/"}, "x": {"z": 2}})
        assert merged.paths.emb == "b/emb/" and merged.x.to_dict() == {"y": 1, "z": 2}


@pytest.mark.parametrize("bad", ["${nope}", "${paths.missing}", "x${paths.data_dir.deeper}"])
def test_interpolation_errors(bad):
    raw = {"paths": {"data_dir": "d/"}, "v": bad}
    with pytest.raises(TCFG.InterpolationError, match="cannot be resolved"):
        _ = TCFG.Config(raw).v
    with pytest.raises(JCFG.InterpolationError, match="cannot be resolved"):
        _ = JCFG.Config(raw).v


def test_save_round_trip(tmp_path):
    """Saved unresolved, loaded back equal; both packages write the same YAML."""
    cfg = TCFG.load_config(os.path.join(REPO, "config.yml"))
    cfg = TCFG.update_cfg(cfg, {"training": {"num_epochs": 1}})
    cfg.save(str(tmp_path / "t.yml"))
    JCFG.update_cfg(JCFG.load_config(os.path.join(REPO, "config.yml")),
                    {"training": {"num_epochs": 1}}).save(str(tmp_path / "j.yml"))
    assert (tmp_path / "t.yml").read_text() == (tmp_path / "j.yml").read_text()
    again = TCFG.load_config(str(tmp_path / "t.yml"))
    assert again == cfg and again.paths.embeddings_path == "coco_data/embeddings/"
    assert yaml.safe_load(open(tmp_path / "t.yml"))["paths"]["embeddings_path"] == \
        "${paths.data_dir}embeddings/"
    cfg.save_json(str(tmp_path / "t.json"))
    assert yaml.safe_load(open(tmp_path / "t.json")) == cfg.to_dict(resolve=True)


def test_access_and_missing_keys():
    cfg = TCFG.Config({"a": {"b": 1}, "tpu": {"mesh": {"dp": -1}}})
    assert cfg.a.b == cfg["a"]["b"] == 1 and cfg.tpu.mesh.dp == -1
    assert cfg.get("nope", 7) == 7 and "a" in cfg and len(cfg) == 2
    with pytest.raises(AttributeError):
        _ = cfg.nope
    cfg.c = TCFG.Config({"d": 2})
    assert cfg.to_dict() == {"a": {"b": 1}, "tpu": {"mesh": {"dp": -1}}, "c": {"d": 2}}
