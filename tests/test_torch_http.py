"""The port's HTTP endpoints against the JAX package's, on a tiny CLIP tower
and a tiny float32 captioner with the same weights: ``serve_http``
(coalesced fixed batches) and ``serve_http_continuous`` (rolling
admission) give the same captions, status codes and error keys; a 504 on a
tiny ``request_timeout_s``, a 500 for every waiter when the service raises,
coalescing under concurrent clients, the continuous endpoint's query
checks, and "server shut down" for the waiters at shutdown."""

import contextlib
import http.client
import io
import json
import threading
import time

import jax
import numpy as np
import pytest
from jax._src import config as jax_config
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from gpt2_image_captioning_tpu.core.precision import F32 as JF32
from gpt2_image_captioning_tpu.models import captioner as JC
from gpt2_image_captioning_tpu.models import clip as JCL
from gpt2_image_captioning_tpu.models import gpt2 as JG
from gpt2_image_captioning_tpu.models import mapping as JM
from gpt2_image_captioning_tpu import serving as JS
from gpt2_image_captioning_tpu_torch import serving as TS
from gpt2_image_captioning_tpu_torch.core.precision import F32
from gpt2_image_captioning_tpu_torch.data import tokenizer as TT
from gpt2_image_captioning_tpu_torch.models import captioner as TC
from gpt2_image_captioning_tpu_torch.models import clip as TCL
from gpt2_image_captioning_tpu_torch.models import gpt2 as TG
from gpt2_image_captioning_tpu_torch.models import mapping as TM
from gpt2_image_captioning_tpu_torch.models import porting

from helpers import tiny_tokenizer

KW = dict(encoder="clip", batch_size=4, max_length=6)
CONT = dict(encoder="clip", slots=3, segment=2, bursts=2, admit=2, max_length=6)


@pytest.fixture(scope="module")
def models():
    """The tiny CLIP tower and a tiny captioner fed by it, in both packages."""
    tok = tiny_tokenizer()
    n = len(tok.encoder)
    vcfg, tvcfg = JCL.CLIPVisionConfig.tiny(), TCL.CLIPVisionConfig.tiny()
    jv = JCL.init_vision(jax.random.PRNGKey(0), vcfg)
    tv = porting.vision_from_jax_numpy(jax.tree.map(np.asarray, jv), device="cpu")
    gkw = dict(vocab_size=n, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    mkw = dict(prefix_length=2, embed_dim=vcfg.projection_dim, gpt_dim=32)
    jcfg = JC.CaptionerConfig(gpt2=JG.GPT2Config(**gkw), mapping=JM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    tcfg = TC.CaptionerConfig(gpt2=TG.GPT2Config(**gkw), mapping=TM.MLPMappingConfig(**mkw),
                              eos_token_id=n - 1)
    jmodel = JC.ImageCaptioningModel(jcfg, tokenizer=tok, rng=jax.random.PRNGKey(4))
    merges = sorted(tok.bpe_ranks, key=tok.bpe_ranks.get)
    tmodel = TC.ImageCaptioningModel(tcfg, tokenizer=TT.GPT2BPETokenizer(dict(tok.encoder), merges),
                                     device="cpu")
    tmodel.trainable, tmodel.frozen = porting.from_jax_numpy(
        *jax.tree.map(np.asarray, (jmodel.trainable, jmodel.frozen)), tcfg, device="cpu")
    return jmodel, tmodel, jv, tv, vcfg, tvcfg


def _bodies(n, seed=8, fmt="JPEG"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, size=(40 + 7 * i, 52 - 3 * i, 3), dtype=np.uint8)
                        ).save(buf, format=fmt)
        out.append(buf.getvalue())
    return out


@contextlib.contextmanager
def running(server):
    """``serve_forever`` on a thread; shut down and closed at exit."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


@contextlib.contextmanager
def global_interpret():
    """Pallas interpret mode for every thread: the JAX server's service thread
    traces the kernels too."""
    st = jax_config.pallas_tpu_interpret_mode_context_manager
    prev = st.get_global()
    st.set_global(pltpu.InterpretParams())
    try:
        yield
    finally:
        st.set_global(prev)


def request(port, method="POST", path="/caption", body=b"", headers=None):
    """(status, parsed JSON body) of one request; ``headers`` replace the
    computed Content-Length."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.putrequest(method, path)
        headers = headers if headers is not None else {"Content-Length": str(len(body))}
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _services(models, **kw):
    jmodel, tmodel, jv, tv, vcfg, tvcfg = models
    kw = {**KW, **kw}
    return (JS.CaptionService(jmodel, jv, vcfg, policy=JF32, **kw),
            TS.CaptionService(tmodel, tv, tvcfg, policy=F32, **kw))


def test_http_captions_match_jax(models):
    """The same JPEG bodies POSTed one by one to the JAX server and to the
    port's give the same captions, which are the service's own; /healthz
    answers."""
    jsvc, svc = _services(models)
    bodies = _bodies(5)
    got, want = [], []
    with running(TS.serve_http(svc, port=0, window_ms=1.0)) as port:
        for b in bodies:
            status, out = request(port, body=b)
            assert status == 200
            got.append(out["caption"])
        status, health = request(port, "GET", "/healthz", headers={})
        assert status == 200 and health["ok"] is True and health["images"] == 5
    with running(JS.serve_http(jsvc, port=0, window_ms=1.0)) as port:
        for b in bodies:
            want.append(request(port, body=b)[1]["caption"])
    assert got == want == svc.caption_bytes(bodies)


# (method, path, body, headers): the answers both servers give before any
# device call — 404 for another path, 400 for a body that is no image, 411
# for a malformed Content-Length, 413 for one above the limit (nothing read)
BAD_REQUESTS = {
    "get_404": ("GET", "/nope", b"", {}),
    "post_404": ("POST", "/nope", b"x", None),
    "junk_400": ("POST", "/caption", b"not an image", None),
    "empty_400": ("POST", "/caption", b"", {}),
    "length_411": ("POST", "/caption", b"", {"Content-Length": "abc"}),
    "huge_413": ("POST", "/caption", b"x", {"Content-Length": str(1 << 30)}),
    "negative_413": ("POST", "/caption", b"", {"Content-Length": "-1"}),
}


@pytest.fixture(scope="module")
def both_servers(models):
    jsvc, svc = _services(models)
    with running(JS.serve_http(jsvc, port=0)) as jport, running(TS.serve_http(svc, port=0)) as port:
        yield jport, port


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_http_errors_match_jax(both_servers, case):
    jport, port = both_servers
    method, path, body, headers = BAD_REQUESTS[case]
    got, want = request(port, method, path, body, headers), request(jport, method, path, body,
                                                                       headers)
    assert got[0] == want[0] == int(case[-3:])
    assert set(got[1]) == set(want[1]) == {"error"}
    assert got[1]["error"].split(":")[0] == want[1]["error"].split(":")[0]


@pytest.mark.parametrize("fault", ["timeout", "raise"])
def test_http_504_and_500_match_jax(models, fault):
    """A batch slower than ``request_timeout_s`` answers 504; a service that
    raises answers 500 with its message to every waiter of the batch — in
    both packages."""
    answers = {}
    for name, svc in zip(("jax", "port"), _services(models)):
        gate = threading.Event()

        def broken(prepped, gate=gate):
            if fault == "timeout":
                gate.wait(5.0)
                return ["late"] * len(prepped)
            raise RuntimeError("device lost")

        svc.caption_prepped = broken
        serve = JS.serve_http if name == "jax" else TS.serve_http
        server = serve(svc, port=0, window_ms=100.0,
                       request_timeout_s=0.2 if fault == "timeout" else 60.0)
        out = [None] * 3
        with running(server) as port:
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(
                i, request(port, body=_bodies(1)[0]))) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            gate.set()
        answers[name] = out
    want = (504, {"error": "caption batch timed out"}) if fault == "timeout" else (
        500, {"error": "device lost"})
    assert answers["port"] == answers["jax"] == [want] * 3


def test_http_coalesces_concurrent_clients(models):
    """16 concurrent clients: every one gets its image's caption, in fewer
    device calls than requests."""
    _, svc = _services(models)
    bodies = _bodies(16, seed=9, fmt="PNG")
    want = svc.caption_bytes(bodies)
    calls = []
    caption_prepped = svc.caption_prepped

    def counted(prepped):
        calls.append(len(prepped))
        return caption_prepped(prepped)

    svc.caption_prepped = counted
    got = [None] * len(bodies)
    with running(TS.serve_http(svc, port=0, window_ms=200.0)) as port:
        threads = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, request(port, body=bodies[i])[1]["caption"])) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert got == want
    assert sum(calls) == 16 and len(calls) < 16


def test_http_shutdown_joins_the_dispatcher(models):
    _, svc = _services(models)
    server = TS.serve_http(svc, port=0)
    with running(server):
        assert server.dispatcher_thread.is_alive()
    assert not server.dispatcher_thread.is_alive()


# query strings of the continuous endpoint: (query, the status both give)
QUERIES = {
    "max_length_2": ("?max_length=2", 200),
    "max_length_99": ("?max_length=99", 400),
    "max_length_0": ("?max_length=0", 400),
    "max_length_word": ("?max_length=two", 400),
    "temperature_0": ("?temperature=0", 200),
    "temperature_greedy_service": ("?temperature=0.5", 400),
    "temperature_negative": ("?temperature=-1", 400),
    "top_p_0": ("?top_p=0", 400),
    "top_p_1_5": ("?top_p=1.5", 400),
    "top_p_1": ("?top_p=1", 200),
}


@pytest.fixture(scope="module")
def continuous_answers(models):
    """Every query of QUERIES and 4 plain POSTs (concurrent) to the JAX
    continuous server and the port's: {name: (status, body)} of each."""
    jmodel, tmodel, jv, tv, vcfg, tvcfg = models
    bodies = _bodies(4, seed=11, fmt="PNG")
    answers = {}
    for name in ("jax", "port"):
        with global_interpret() if name == "jax" else contextlib.nullcontext():
            if name == "jax":
                svc = JS.ContinuousCaptionService(jmodel, jv, vcfg, **CONT)
                server = JS.serve_http_continuous(svc, port=0)
            else:
                svc = TS.ContinuousCaptionService(tmodel, tv, tvcfg, **CONT)
                server = TS.serve_http_continuous(svc, port=0)
            out = {}
            with running(server) as port:
                threads = [threading.Thread(target=lambda i=i: out.__setitem__(
                    f"plain_{i}", request(port, body=bodies[i]))) for i in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(120)
                for q, (query, _) in QUERIES.items():
                    out[q] = request(port, path="/caption" + query, body=bodies[0])
                out["health"] = request(port, "GET", "/healthz", headers={})
            answers[name] = out
    return answers, bodies


def test_http_continuous_captions_match_jax(continuous_answers, models):
    """Concurrent POSTs ride the rolling pool and get the JAX server's
    captions, which are the port's fixed-batch service's; /healthz counts
    them."""
    answers, bodies = continuous_answers
    for i in range(4):
        assert answers["port"][f"plain_{i}"] == answers["jax"][f"plain_{i}"]
        assert answers["port"][f"plain_{i}"][0] == 200
    _, svc = _services(models)
    assert [answers["port"][f"plain_{i}"][1]["caption"] for i in range(4)] == \
        svc.caption_bytes(bodies)
    status, health = answers["port"]["health"]
    assert status == 200 and health["ok"] is True and health["images"] >= 7


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_http_continuous_queries_match_jax(continuous_answers, case):
    answers, _ = continuous_answers
    got, want = answers["port"][case], answers["jax"][case]
    assert got[0] == want[0] == QUERIES[case][1]
    assert got[1] == want[1]


def test_http_continuous_fails_waiters_at_shutdown(models):
    """Requests still in the pool when the server shuts down are answered
    500 "server shut down", and the pump is joined."""
    _, tmodel, _, tv, _, tvcfg = models
    svc = TS.ContinuousCaptionService(tmodel, tv, tvcfg, **CONT)
    submitted, both_in = [], threading.Event()
    submit = svc.submit_prepped

    def counted(*a):
        submitted.append(1)
        return submit(*a)

    def stalled_step():  # the pool never moves: both requests stay waiting
        if len(submitted) == 2:
            both_in.set()
        time.sleep(0.01)
        return {}

    svc.submit_prepped, svc.step = counted, stalled_step
    server = TS.serve_http_continuous(svc, port=0)
    out = [None] * 2
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    clients = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, request(server.server_address[1], body=_bodies(1, seed=i)[0]))) for i in range(2)]
    for c in clients:
        c.start()
    assert both_in.wait(30)
    server.shutdown()
    for c in clients:
        c.join(30)
    server.server_close()
    assert not server.pump_thread.is_alive()
    assert out == [(500, {"error": "server shut down"})] * 2
