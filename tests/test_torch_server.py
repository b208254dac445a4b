"""The port's HTTP serving daemon (``infer/server.py`` + ``cli/serve.py``)
vs the JAX package, the counterparts of ``tests/test_server.py``'s cases.

Real HTTP round-trips on 127.0.0.1 (port 0) against an in-process
``AVSRServer`` on the CPU with 2 slots: health, transcription, concurrent
clients sharing the pool, input validation, fault recovery, timeout
cancels, adapters (a hot onboarded tenant), auth, the body cap and the beam
lane. Responses are held to the standalone decodes of both packages
(``generate_tokens``, with the tenant's adapter grafted on, and
``beam_search``) with the weights of ``tests/test_torch_engine.py``.
Tolerance: exact equality of tokens.
"""

import http.client
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.data import loader as jloader
from avsr_tpu.infer import adapters as jad
from avsr_tpu_torch.cli import serve as tserve
from avsr_tpu_torch.convert import from_numpy_tree
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.infer import adapters as tad
from avsr_tpu_torch.infer import generate as tgen
from avsr_tpu_torch.infer.server import AVSRServer
from avsr_tpu_torch.train.checkpoint import export_params

from test_torch_engine import (TINY_YAML, Tok, configs, model, np_adapter, ref_j, ref_t,
                               samples)
from test_torch_models import np_tree

torch.set_num_threads(1)

jgen = importlib.import_module("avsr_tpu.infer.generate")

MAX_NEW = 6


@pytest.fixture(scope="module")
def server():
    jc, tc = configs()
    p_j, p_t = model(jc)
    srv = AVSRServer(p_t, tc, Tok(), port=0, num_slots=2, request_timeout_s=600.0)
    srv.start()
    srv.jc, srv.p_j = jc, p_j
    yield srv
    srv.stop()


def _post(srv, payload: dict, path: str = "/v1/transcribe", headers=None, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(srv, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _pair(n, seed):
    ts, js = samples([n], seed=seed)
    return ts[0], js[0]


def _want(srv, t, j, params_t=None, params_j=None, max_new=MAX_NEW):
    """The port's and JAX's standalone decode of one request (equal)."""
    want = ref_t(params_t or srv.engine.params, srv.cfg, srv.tok, t, max_new)
    assert want == ref_j(params_j or srv.p_j, srv.jc, srv.tok, j, max_new)
    return want


def test_health(server):
    h = _get(server, "/v1/health")
    assert h["ok"] is True
    assert h["model"]["modality"] == "audio"
    assert h["model"]["slots"] == 2


def test_transcribe_deterministic_and_token_exact(server):
    t, j = _pair(4800, 0)
    body = {"audio": t.audio.tolist(), "max_new_tokens": MAX_NEW}
    r1, r2 = _post(server, body), _post(server, body)
    assert r1["tokens"] == r2["tokens"]
    assert r1["n_tokens"] == len(r1["tokens"]) > 0
    assert r1["text"] == server.tok.decode(r1["tokens"])
    assert r1["tokens"] == _want(server, t, j)


def test_concurrent_clients_share_pool(server):
    """4 clients, 2 slots: all succeed, each equal to its standalone
    decode; identical audio gives identical tokens in any slot mix."""
    ts, js = samples([4800, 8000, 6400, 4800], seed=1)
    ts[3], js[3] = ts[0], js[0]
    results, errors = [None] * 4, []

    def client(i):
        try:
            results[i] = _post(server, {"audio": ts[i].audio.tolist(),
                                        "max_new_tokens": MAX_NEW})
        except Exception as e:
            errors.append(e)

    before = server.engine.requests_done
    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not errors
    assert server.engine.requests_done - before >= 4
    assert results[0]["tokens"] == results[3]["tokens"]
    for i in range(3):
        assert results[i]["tokens"] == _want(server, ts[i], js[i]), i


def test_bad_requests(server):
    for body in ({"max_new_tokens": 4}, {"audio_path": "/nonexistent/x.wav"},
                 {"audio": [[0.0, 1.0]]}, {"audio": [0.0], "temperature": "hot"},
                 {"audio": [0.0], "num_beams": 17},
                 {"audio": [0.0] * 100, "max_new_tokens": 10 ** 6}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body)
        assert e.value.code == 400, body
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/v1/nope")
    assert e.value.code == 404


def test_stats_endpoint(server):
    _post(server, {"audio": _pair(4800, 2)[0].audio.tolist(), "max_new_tokens": 2})
    s = _get(server, "/v1/stats")
    assert s["requests_done"] >= 1
    assert set(s) == {"requests_done", "requests_cancelled", "tokens_emitted", "chunks_run",
                      "decode_steps", "stages_run", "installs_run", "chunk_utilization"}


def test_server_recovers_from_engine_fault(server):
    """An engine.step fault fails the inflight request with a 500, resets
    the pool, and the very next request succeeds token-exact."""
    eng = server.engine
    real_step = eng.step
    fired = []

    def flaky_step():
        if not fired:
            fired.append(1)
            raise RuntimeError("injected fault")
        return real_step()

    t, j = _pair(4800, 3)
    body = {"audio": t.audio.tolist(), "max_new_tokens": MAX_NEW}
    eng.step = flaky_step
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body)
        assert e.value.code == 500
        assert "injected fault" in json.loads(e.value.read())["error"]
        r = _post(server, body)
    finally:
        del eng.step
    assert r["tokens"] == _want(server, t, j)


def test_server_timeout_cancels_request(server):
    """A client timeout returns 504 AND reclaims the request's engine
    capacity; the pool then serves the next client."""
    t, _ = _pair(16000, 4)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"audio": t.audio.tolist(), "max_new_tokens": 64,
                       "timeout_s": 0.001})
    assert e.value.code == 504
    assert json.loads(e.value.read())["cancelled"] is True
    deadline = time.time() + 300
    while server.engine.outstanding() and time.time() < deadline:
        time.sleep(0.05)
    assert server.engine.outstanding() == 0
    assert _post(server, {"audio": t.audio.tolist(), "max_new_tokens": MAX_NEW})["n_tokens"] > 0


def test_server_timeout_cancels_a_resident_request(server):
    """The cancel reaches the engine: the request is submitted, its
    client times out while the scheduler is inside a (slowed) step, and
    the engine cancels it instead of decoding it to its end."""
    eng = server.engine
    real_step = eng.step

    def slow_step():
        time.sleep(1.0)                      # the handler times out meanwhile
        return real_step()

    done, cancelled, nxt = eng.requests_done, eng.requests_cancelled, eng._next_req
    eng.step = slow_step
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"audio": _pair(8000, 9)[0].audio.tolist(), "max_new_tokens": 8,
                           "timeout_s": 0.5})
        assert e.value.code == 504
        assert json.loads(e.value.read())["req_id"] == nxt
        deadline = time.time() + 60
        while time.time() < deadline and not (
                eng.outstanding() == 0 and eng.requests_cancelled == cancelled + 1):
            time.sleep(0.05)
    finally:
        del eng.step
    assert eng._next_req == nxt + 1
    assert (eng.requests_cancelled, eng.requests_done) == (cancelled + 1, done)


def test_server_adapter_field(server):
    """adapter 0 is always valid (a bank-less engine serves the base); an
    out-of-range row is a 400 from the handler."""
    audio = _pair(4800, 5)[0].audio.tolist()
    assert _post(server, {"audio": audio, "max_new_tokens": 4, "adapter": 0})["n_tokens"] > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"audio": audio, "adapter": 99})
    assert e.value.code == 400


def _tenant(server, tmp_path, name, seed):
    """Export a tenant (the base with a random adapter) and return its JAX
    and port trees."""
    skel = np_tree(jad.extract_lora(server.p_j["llm"]))
    a_np = np_adapter(skel, seed)
    a_t = from_numpy_tree(a_np, "cpu")
    tenant_t = {**server.engine.params,
                "llm": tad.inject_lora(server.engine.params["llm"], a_t)}
    tenant_j = {**server.p_j, "llm": jad.inject_lora(
        server.p_j["llm"], jax.tree_util.tree_map(jnp.asarray, a_np))}
    export_params(tenant_t, tmp_path / name)
    return tenant_t, tenant_j


def test_server_hot_onboard_adapter_and_idempotence(server, tmp_path):
    """POST /v1/adapters onboards a tenant into the RUNNING server: its id
    transcribes as the standalone decode with that adapter grafted on (in
    both packages), adapter 0 keeps serving the base, and re-posting the
    same checkpoint returns the same row without a duplicate."""
    tenant_t, tenant_j = _tenant(server, tmp_path, "tenant", 77)
    k = _post(server, {"checkpoint": str(tmp_path / "tenant")}, "/v1/adapters")["adapter"]
    assert k >= 1
    n = server.engine._n_adapters
    assert _post(server, {"checkpoint": str(tmp_path / "tenant")}, "/v1/adapters")[
        "adapter"] == k
    assert server.engine._n_adapters == n
    t, j = _pair(4800, 6)
    got = _post(server, {"audio": t.audio.tolist(), "max_new_tokens": MAX_NEW, "adapter": k})
    assert got["tokens"] == _want(server, t, j, tenant_t, tenant_j)
    base = _post(server, {"audio": t.audio.tolist(), "max_new_tokens": MAX_NEW, "adapter": 0})
    assert base["tokens"] == _want(server, t, j)
    assert got["tokens"] != base["tokens"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"checkpoint": str(tmp_path / "missing")}, "/v1/adapters")
    assert e.value.code == 400


def test_server_auth_and_body_cap(server):
    """Bearer-token auth on POST routes (health stays open) and the body
    cap (413 before the body is read)."""
    body = {"audio": _pair(4800, 7)[0].audio.tolist(), "max_new_tokens": 4}
    server.auth_token = "s3cret"
    try:
        for hdr in (None, {"Authorization": "Bearer wrong"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(server, body, headers=hdr)
            assert e.value.code == 401
        assert _get(server, "/v1/health")["ok"] is True
        assert _post(server, body, headers={"Authorization": "Bearer s3cret"})["n_tokens"] > 0
    finally:
        server.auth_token = None
    server.max_body_bytes = 64
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, body)
        assert e.value.code == 413
    finally:
        server.max_body_bytes = 64 * 1024 * 1024
    assert _post(server, body)["n_tokens"] > 0


def test_server_negative_content_length_rejected(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        conn.putrequest("POST", "/v1/transcribe", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        resp.read()
    finally:
        conn.close()


def test_server_mixed_greedy_and_beam_clients(server):
    """Beam clients ride a static beam_search lane, batched among
    themselves between engine chunks: equal to a standalone beam_search of
    both packages; greedy clients keep the engine contract alongside."""
    ts, js = samples([4800, 8000, 6400, 4800], seed=8)
    beams = (0, 2)
    results, errors = [None] * 4, []

    def client(i):
        body = {"audio": ts[i].audio.tolist(), "max_new_tokens": MAX_NEW}
        if i in beams:
            body["num_beams"] = 3
        try:
            results[i] = _post(server, body)
        except Exception as e:
            errors.append((i, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    assert not errors
    cfg, tok = server.cfg, server.tok
    prompt = tok.encode(cfg.model.prompt, add_bos=True)
    for i in beams:
        hb = tloader.collate([ts[i]], cfg.data, prompt, tok.pad_id)
        out = tgen.beam_search(server.engine.params, cfg.model,
                               tloader.featurize(hb, "cpu", torch.float32),
                               max_new_tokens=MAX_NEW, num_beams=3, eos_id=tok.eos_id)
        want = out.tokens[0, : int(out.lengths[0])].tolist()
        jhb = jloader.collate([js[i]], server.jc.data, prompt, tok.pad_id)
        jb = jloader.featurize(jhb, "float32", jloader.audio_frontend_for(server.jc.model),
                               jloader.image_stats_for(server.jc.model))
        jo = jgen.beam_search(server.p_j, server.jc.model, jb, max_new_tokens=MAX_NEW,
                              num_beams=3, eos_id=tok.eos_id, compute_dtype="float32",
                              use_pallas="never")
        assert want == [int(x) for x in np.asarray(jo.tokens)[0, : int(jo.lengths[0])]]
        assert results[i]["tokens"] == want, i
        assert results[i]["req_id"] < 0
    for i in (1, 3):
        assert results[i]["tokens"] == _want(server, ts[i], js[i])
    for body in ({"num_beams": 3, "temperature": 0.7}, {"num_beams": 3, "adapter": 1}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, {"audio": ts[0].audio.tolist(), **body})
        assert e.value.code == 400


def test_server_refuses_av_modality():
    _, tc = configs(**{"model.modality": "both"})
    with pytest.raises(ValueError, match="modality='audio'"):
        AVSRServer({}, tc, Tok())


@pytest.mark.parametrize("extra", [["--no-warmup", "--slots", "3"],
                                   ["--allow-onboarding", "--token", "t0k"]],
                         ids=["plain", "onboarding"])
def test_serve_cli_builds_and_serves(extra):
    """The serve CLI on the CPU: flags to an engine (slots, the raw base
    for onboarding, the token), warmup on the scheduler thread, a real
    request, a clean stop."""
    srv = tserve.build_server(["--config", str(TINY_YAML), "--device", "cpu", "--port", "0",
                               "decode.engine_slots=2", *extra])
    srv.start()
    try:
        assert srv.engine.S == (3 if "--slots" in extra else 2)
        onboarding = "--allow-onboarding" in extra
        assert ("qkv" in srv.engine.params["llm"]["layers"][0]) != onboarding
        assert srv.auth_token == ("t0k" if onboarding else None)
        hdr = {"Authorization": "Bearer t0k"} if onboarding else None
        r = _post(srv, {"audio": [0.1] * 4000, "max_new_tokens": 3}, headers=hdr)
        assert 1 <= r["n_tokens"] <= 3
        assert _get(srv, "/v1/health")["stats"]["requests_done"] == 1
    finally:
        srv.stop()
