"""The port's results viewer against the JAX package's:
``create_captioning_dataset`` joins the same samples, the gallery page and
the images are served, a path that leaves the images directory is refused,
and ``python -m gpt2_image_captioning_tpu_torch.viz`` takes the arguments of
``visualize_my_results.py`` (``--compute-metrics`` included)."""

import json
import urllib.error
import urllib.request

import pytest

import visualize_my_results as jcli
from gpt2_image_captioning_tpu.evaluation.evaluate import per_image_metrics as jper_image
from gpt2_image_captioning_tpu.viz import create_captioning_dataset as jcreate
from gpt2_image_captioning_tpu_torch.evaluation.evaluate import per_image_metrics
from gpt2_image_captioning_tpu_torch.viz import __main__ as tcli
from gpt2_image_captioning_tpu_torch.viz import create_captioning_dataset, launch_app

from helpers import make_synthetic_coco


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Predictions for 6 images (one not in the annotations), annotations,
    and an images directory holding 4 of their files plus a file beside it."""
    root = tmp_path_factory.mktemp("viz")
    _, ann, ids = make_synthetic_coco(root, n_images=5, captions_per_image=3, prefix="val")
    names = {im["id"]: im["file_name"] for im in json.load(open(ann))["images"]}
    images = root / "images"
    images.mkdir()
    for iid in ids[:4]:
        (images / names[iid]).write_bytes(b"\x89PNG fake " + str(iid).encode())
    (root / "secret.txt").write_text("outside the images directory")
    preds = [{"image_id": iid, "caption": f"a cat on the dog {k}"} for k, iid in enumerate(ids)]
    preds.append({"image_id": 77, "caption": "no references"})
    (root / "preds.json").write_text(json.dumps(preds))
    return root, str(root / "preds.json"), str(images), ann, names


def assert_close(got, want):
    """Nested dicts and lists equal, floats within 1e-9 relative."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_close(a, b)
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("with_metrics", [False, True])
def test_dataset_matches_jax(results, with_metrics):
    root, preds, images, ann, _ = results
    metrics = per_image_metrics(json.load(open(preds)), ann) if with_metrics else None
    if with_metrics:
        assert_close(metrics, jper_image(json.load(open(preds)), ann))
    got = create_captioning_dataset(preds, images, ann, metrics=metrics, dataset_name="t")
    want = jcreate(preds, images, ann, metrics=metrics, dataset_name="t")
    assert got == want
    assert [s["exists"] for s in got] == [True] * 4 + [False, False]
    assert got[-1]["file_name"] == "000000000077.jpg" and got[-1]["references"] == []


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read()


def test_page_images_and_traversal(results):
    """The page embeds every sample, an image is served byte for byte, and
    paths outside the images directory, missing files and other routes
    answer 404."""
    root, preds, images, ann, names = results
    samples = create_captioning_dataset(preds, images, ann)
    server = launch_app(samples, images, port=0, blocking=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, page = _get(base + "/")
        assert status == 200 and b"Caption results" in page
        assert json.dumps(samples).encode() in page
        fname = samples[0]["file_name"]
        assert _get(f"{base}/images/{fname}") == (200, (root / "images" / fname).read_bytes())
        for path in ("/images/../secret.txt", "/images/..%2Fsecret.txt",
                     "/images/../images/../secret.txt", "/images/missing.jpg", "/nope"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + path)
            assert e.value.code == 404, path
    finally:
        server.shutdown()
        server.server_close()


def test_cli_matches_visualize_my_results(results, monkeypatch):
    """The same arguments to ``visualize_my_results.py`` and to the port's
    ``python -m ...viz`` hand the viewer the same samples and options."""
    root, preds, images, ann, _ = results
    calls = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        monkeypatch.setattr(mod, "launch_app",
                            lambda samples, d, name=name, **kw: calls.__setitem__(
                                name, (samples, d, kw)))
    argv = ["--predictions", preds, "--images-dir", images, "--annotations", ann,
            "--compute-metrics", "--port", "5199", "--no-browser"]
    monkeypatch.setattr("sys.argv", ["visualize_my_results.py", *argv])
    jcli.main()
    tcli.main(argv)
    assert_close(calls["port"][0], calls["jax"][0])
    assert calls["port"][1:] == calls["jax"][1:] == (images, {"port": 5199,
                                                              "open_browser": False})
    assert any(s["metrics"] for s in calls["port"][0])
    (root / "m.json").write_text(json.dumps({str(s["image_id"]): {"CIDEr": 1.5}
                                             for s in calls["port"][0]}))
    tcli.main(argv[:6] + ["--metrics", str(root / "m.json"), "--no-browser"])
    assert all(s["metrics"] == {"CIDEr": 1.5} for s in calls["port"][0])
