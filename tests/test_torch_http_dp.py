"""The port's HTTP endpoints over a service of several ranks, against the
JAX package's endpoints over a dp-2 mesh of virtual CPU devices, on the
same tiny CLIP tower and tiny float32 captioner (``tests/test_torch_http.py``'s
config).

One launch of two gloo ranks (``tests/torch_dist_worker.py``, task
``http_dp``): for ``serve_http`` over a dp-2 ``CaptionService`` and then
``serve_http_continuous`` over a dp-2 ``ContinuousCaptionService``, rank 0
listens on port 0 and posts six PNG bodies to itself from threads (the
continuous endpoint also one with ``?max_length=3``), then an undecodable
body, then another image, reads ``/healthz`` and shuts down; rank 1 gets a
follower whose ``serve_forever()`` replays rank 0's calls until then.

- the greedy captions equal the JAX endpoints' for the same bodies;
- the undecodable body gets 400 and the next request 200;
- ``/healthz`` answers from rank 0's service; the follower's service made
  the same calls (the same image count) and its ``serve_forever()``
  returned at rank 0's shutdown, so the rank exited 0 within its timeout.

In one process, without a launch: a main rank whose broadcast fails (the
followers lost) answers 500 and stops its server.
"""

import contextlib
import json
import threading

import jax
import numpy as np
import pytest

from gpt2_image_captioning_tpu import serving as JS
from gpt2_image_captioning_tpu.core.mesh import MeshSpec, create_mesh
from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu_torch import serving as TS
from gpt2_image_captioning_tpu_torch.core.precision import F32 as TF32
from gpt2_image_captioning_tpu_torch.core.tree import flatten_with_paths

from helpers import tiny_tokenizer
from test_torch_http import CONT, KW, _bodies, global_interpret, models, request, running  # noqa: F401
from torch_dist_worker import launch

SETTINGS = {"fixed": dict(encoder="clip", batch_size=4, max_length=6),
            "continuous": dict(encoder="clip", slots=4, segment=2, bursts=2, admit=2,
                               max_length=6),
            "query": "?max_length=3"}
N_BODIES = 6
MAPPER_SCALE = 5.0


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_with_paths(jax.tree.map(np.asarray,
                                                                         tree)).items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(the two ranks' outputs, the JAX endpoints' answers by kind)."""
    root = tmp_path_factory.mktemp("http_dp")
    tok = tiny_tokenizer()
    n = len(tok.encoder)
    vcfg = JCL.CLIPVisionConfig.tiny()
    jv = JCL.init_vision(jax.random.PRNGKey(0), vcfg)
    gkw = dict(vocab_size=n, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=vcfg.projection_dim, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=tok, rng=jax.random.PRNGKey(4))
    # the mapper scaled up, so that the image moves the caption: at its init
    # scale every body gets one caption, and a follower fed the wrong pixels
    # could not show
    jmodel.trainable = {**jmodel.trainable, "mapping": jax.tree.map(
        lambda w: w * MAPPER_SCALE, jmodel.trainable["mapping"])}
    np.savez(root / "weights.npz", **{f"{name}/{k}": v for name, tree in (
        ("trainable", jmodel.trainable), ("frozen", jmodel.frozen), ("vision", jv))
        for k, v in _flat(tree).items()})
    bodies = _bodies(N_BODIES, seed=13, fmt="PNG")
    np.savez(root / "inputs.npz", **{f"body_{i}": np.frombuffer(b, np.uint8)
                                     for i, b in enumerate(bodies)})
    spec = {"gpt2": gkw, "mapping": mkw, "eos": n - 1, "vocab": dict(tok.encoder),
            "merges": sorted(tok.bpe_ranks, key=tok.bpe_ranks.get), "n_bodies": N_BODIES,
            "http": SETTINGS}
    (root / "spec.json").write_text(json.dumps(spec))
    ranks = launch("http_dp", str(root), timeout=240.0)

    mesh = create_mesh(MeshSpec(dp=2, tp=1), devices=jax.devices()[:2])
    want = {}
    for kind, serve in (("fixed", JS.serve_http), ("continuous", JS.serve_http_continuous)):
        with global_interpret() if kind == "continuous" else contextlib.nullcontext():
            if kind == "fixed":
                svc = JS.CaptionService(jmodel, jv, vcfg, policy=JF32, mesh=mesh,
                                        **SETTINGS["fixed"])
            else:
                svc = JS.ContinuousCaptionService(jmodel, jv, vcfg, mesh=mesh,
                                                  **SETTINGS["continuous"])
            out = {}
            with running(serve(svc, port=0)) as port:
                threads = [threading.Thread(target=lambda i=i: out.__setitem__(
                    i, request(port, body=bodies[i]))) for i in range(N_BODIES)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
                got = {"plain": [out[i] for i in range(N_BODIES)]}
                if kind == "continuous":
                    got["query"] = request(port, path="/caption" + SETTINGS["query"],
                                           body=bodies[0])
            want[kind] = got
    return ranks, want


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_endpoints_over_ranks_answer_the_jax_captions(served, kind):
    """Rank 0's answers to the concurrent POSTs (and the per-request
    max_length) are the JAX endpoints' over their dp-2 mesh."""
    ranks, want = served
    got = ranks[0][kind]
    assert got["server"] == "Server"
    assert all(status == 200 for status, _ in got["plain"])
    assert got["plain"] == want[kind]["plain"]
    assert len({out["caption"] for _, out in got["plain"]}) > 1  # the images tell apart
    if kind == "continuous":
        assert got["query"] == want[kind]["query"] and got["query"][0] == 200


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_bad_body_and_healthz_over_ranks(served, kind):
    """An undecodable body gets 400 on rank 0 and is never sent to rank 1;
    the next request still gets its caption; /healthz answers from rank 0's
    service, which counted every image."""
    ranks, _ = served
    got = ranks[0][kind]
    assert got["bad"][0] == 400 and "not a decodable image" in got["bad"][1]["error"]
    assert got["after_bad"][0] == 200
    assert got["after_bad"][1]["caption"] == got["plain"][1][1]["caption"]
    status, health = got["health"]
    served_images = N_BODIES + 1 + (kind == "continuous")
    assert status == 200 and health["ok"] is True and health["images"] == served_images


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_follower_replays_and_returns_at_shutdown(served, kind):
    """Rank 1 got a follower, not a server: its ``serve_forever()`` returned
    when rank 0 shut down, after its own service had captioned every image
    rank 0 did; rank 0's service thread was joined."""
    ranks, _ = served
    follower = ranks[1][kind]
    assert follower["server"] == "_Follower"
    assert follower["stats"]["images"] == ranks[0][kind]["health"][1]["images"]
    assert ranks[0][kind]["serving_thread_alive"] is False
    assert [r["mesh"] for r in ranks] == [{"dp": 2, "rank": r, "backend": "gloo"}
                                         for r in range(2)]


class _LostRelay(TS._Relay):
    """The main rank's relay whose followers are gone: every broadcast
    raises, as a gloo broadcast to a dead peer does."""

    def __init__(self):
        self.is_main, self.lost = True, None

    def send(self, *args):
        raise RuntimeError("Connection closed by peer")


@pytest.mark.parametrize("kind", ["fixed", "continuous"])
def test_lost_followers_fail_the_request_and_stop_the_server(models, monkeypatch, kind):
    """A broadcast that fails answers 500 to the waiting request at once (not
    a 504 after ``request_timeout_s``), ends the service thread and stops
    the server listening."""
    _, tmodel, _, tv, _, tvcfg = models
    monkeypatch.setattr(TS, "_relay", lambda service: _LostRelay())
    if kind == "fixed":
        server = TS.serve_http(TS.CaptionService(tmodel, tv, tvcfg, policy=TF32, **KW), port=0)
        thread = server.dispatcher_thread
    else:
        server = TS.serve_http_continuous(TS.ContinuousCaptionService(tmodel, tv, tvcfg, **CONT),
                                          port=0)
        thread = server.pump_thread
    listening = threading.Thread(target=server.serve_forever, daemon=True)
    listening.start()
    try:
        status, body = request(server.server_address[1], body=_bodies(1)[0])
        thread.join(30)
        listening.join(30)
    finally:
        server.shutdown()
        server.server_close()
    assert status == 500 and body["error"].startswith("the service's other ranks are lost")
    assert not thread.is_alive() and not listening.is_alive()
