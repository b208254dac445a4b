"""HTTP serving daemon over the continuous-batching engine, the port of
``avsr_tpu/infer/server.py``: JSON over stdlib ``http.server``.

  * every HTTP handler thread parses its request into host arrays (numpy),
    enqueues it and blocks on an event; handler threads never touch a
    device tensor;
  * ONE scheduler thread owns the engine (it is not thread-safe, and it is
    the only thread that launches work on the card): it drains the queue
    via ``engine.submit`` and advances the pool with ``engine.step``;
  * concurrent requests therefore share the slot pool — continuous
    batching across independent HTTP clients, with per-request sampling
    knobs, budgets and adapters.

Endpoints:
  POST /v1/transcribe   {"audio": [f32...]} | {"audio_b64": <wav bytes>} |
                        {"audio_path": "..."}  (+ optional "temperature",
                        "top_p", "max_new_tokens", "timeout_s", "adapter"
                        — the LoRA bank row of a multi-tenant engine — and
                        "num_beams": > 1 routes the request to a static
                        beam-search lane that batches beam clients among
                        themselves between engine chunks, token-exact vs
                        ``infer/generate.py::beam_search``)
                        -> {"req_id", "text", "tokens", "n_tokens"}
                        (a timed-out request is CANCELLED in the engine —
                        its slot capacity is reclaimed; the 504 carries
                        "cancelled": true)
  POST /v1/adapters     {"checkpoint": path} -> {"adapter": k} — onboard a
                        LoRA tenant into the running pool (no restart;
                        resident requests unaffected; idempotent per
                        checkpoint; see ServingEngine.add_adapter)
  GET  /v1/health       -> {"ok", "outstanding", "model", "stats"}
  GET  /v1/stats        -> engine.stats()

A bearer token (``auth_token``) guards the POST routes, compared with
``hmac.compare_digest``; bodies above ``max_body_bytes`` get 413 and a
negative Content-Length 400.
"""

from __future__ import annotations

import base64
import hmac
import json
import logging
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from avsr_tpu_torch.core.config import AVSRConfig
from avsr_tpu_torch.data.dataset import Sample

log = logging.getLogger("avsr_tpu_torch.server")


@dataclass
class _Pending:
    sample: Sample
    max_new: int | None
    temperature: float
    top_p: float
    adapter: int = 0
    num_beams: int = 1             # > 1 routes to the static beam lane
    event: threading.Event = field(default_factory=threading.Event)
    req_id: int | None = None
    tokens: list[int] | None = None
    error: str | None = None
    # set by the handler thread when its client gave up (timeout); the
    # scheduler checks it around submit so the request is cancelled
    # whichever side of the submit the flag landed on
    abandoned: bool = False


@dataclass
class _AdminAdd:
    """Adapter onboarding op: the handler thread reads the adapter's
    leaves to the CPU, the scheduler — sole owner of the engine — applies
    it. ``key`` (the resolved checkpoint path) makes onboarding idempotent:
    a client that got a 504 can retry and get the existing bank row."""
    adapter: object
    key: str
    event: threading.Event = field(default_factory=threading.Event)
    result: int | None = None
    error: str | None = None
    abandoned: bool = False


class AVSRServer:
    """Own an engine + scheduler thread + HTTP listener.

    ``start()`` returns once the socket is bound (port 0 picks a free one —
    read ``self.port``); ``stop()`` shuts both threads down. With
    ``warmup_sample`` the engine's first launches run on the scheduler
    thread before it takes requests."""

    def __init__(self, params, cfg: AVSRConfig, tok, *,
                 host: str = "127.0.0.1", port: int = 8017,
                 num_slots: int | None = None,
                 warmup_sample: Sample | None = None,
                 request_timeout_s: float = 300.0,
                 adapter_bank=None,
                 auth_token: str | None = None,
                 max_body_bytes: int = 64 * 1024 * 1024):
        from avsr_tpu_torch.infer.engine import ServingEngine

        if cfg.model.modality != "audio":
            raise ValueError(
                "the HTTP server currently serves model.modality='audio' "
                f"(got {cfg.model.modality!r}); use cli.decode for AV "
                "batch work")
        self.cfg = cfg
        self.tok = tok
        self.engine = ServingEngine(
            params, cfg, tok,
            num_slots=num_slots or cfg.decode.engine_slots or 4,
            seed=cfg.training.seed, adapter_bank=adapter_bank)
        self.warmup_sample = warmup_sample
        self.host, self.port = host, port
        self.request_timeout_s = request_timeout_s
        self.auth_token = auth_token
        self.max_body_bytes = int(max_body_bytes)
        self._inq: queue.Queue[_Pending] = queue.Queue()
        self._beamq: queue.Queue[_Pending] = queue.Queue()
        self._cancelq: queue.Queue[int] = queue.Queue()
        self._adminq: queue.Queue[_AdminAdd] = queue.Queue()
        self._beams_served = 0
        self._inflight: dict[int, _Pending] = {}
        # resolved checkpoint path -> bank row, scheduler-thread-only
        self._adapter_ids: dict[str, int] = {}
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._threads: list[threading.Thread] = []
        self._httpd: ThreadingHTTPServer | None = None
        self.started_at = time.time()

    # -- scheduler (sole owner of the engine) ------------------------------

    def _scheduler(self) -> None:
        eng = self.engine
        if self.warmup_sample is not None:
            t0 = time.perf_counter()
            eng.warmup(self.warmup_sample)
            log.info("engine warmup: %.1fs", time.perf_counter() - t0)
        self._ready.set()
        while not self._stop.is_set():
            # admin ops first: adapter onboarding between steps
            while True:
                try:
                    op = self._adminq.get_nowait()
                except queue.Empty:
                    break
                if op.key in self._adapter_ids:   # retry after a 504
                    op.result = self._adapter_ids[op.key]
                    op.event.set()
                    continue
                if op.abandoned:        # its 504 already went out
                    continue
                try:
                    op.result = eng.add_adapter(op.adapter)
                    self._adapter_ids[op.key] = op.result
                except Exception as e:
                    op.error = f"{type(e).__name__}: {e}"
                op.event.set()
            # reclaim slots whose client gave up (handler timed out)
            while True:
                try:
                    rid = self._cancelq.get_nowait()
                except queue.Empty:
                    break
                self._inflight.pop(rid, None)
                eng.cancel(rid)
            # admit everything queued; block briefly only when idle
            block = not eng.outstanding()
            while True:
                try:
                    p = self._inq.get(timeout=0.05 if block else 0)
                except queue.Empty:
                    break
                if p.abandoned:       # client gone before we ever submitted
                    continue
                try:
                    rid = eng.submit(p.sample, max_new=p.max_new,
                                     temperature=p.temperature,
                                     top_p=p.top_p, adapter=p.adapter)
                    p.req_id = rid
                    self._inflight[rid] = p
                    if p.abandoned:   # flag raced in around the submit
                        self._cancelq.put(rid)
                except Exception as e:  # bad media, OOM-sized input, ...
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()
                block = False
            if eng.outstanding():
                try:
                    finished = eng.step()
                except Exception as e:
                    # A failed step poisons every inflight request: fail
                    # them all AND reset the engine's pool state, or
                    # outstanding() keeps reporting the stuck requests and
                    # this loop spins on the poisoned engine forever.
                    log.exception("engine.step failed — resetting pool")
                    for p in self._inflight.values():
                        p.error = f"engine.step: {type(e).__name__}: {e}"
                        p.event.set()
                    self._inflight.clear()
                    eng.reset()
                    time.sleep(0.2)      # backoff if the fault persists
                    continue
                for rid, ids in finished.items():
                    # pop the engine-side copy too, or engine._finished
                    # grows without bound
                    eng.collect(rid)
                    p = self._inflight.pop(rid, None)
                    if p is not None:
                        p.tokens = list(map(int, ids))
                        p.event.set()
            self._serve_beams()

    def _serve_beams(self) -> None:
        """Per-request ``num_beams``: the slot pool decodes one row per
        request and cannot host a beam frontier, so beam requests take a
        static lane — they batch among themselves and run one
        ``beam_search`` call between engine chunks, on the same resident
        params (the slot pool pauses meanwhile)."""
        first: _Pending | None = None
        while first is None:
            try:
                first = self._beamq.get_nowait()
            except queue.Empty:
                return
            if first.abandoned:
                first = None
        # batch only requests with identical (num_beams, max_new); other
        # groups wait a scheduler loop
        group, defer = [first], []
        while len(group) < 8:
            try:
                p = self._beamq.get_nowait()
            except queue.Empty:
                break
            if p.abandoned:
                continue
            if (p.num_beams, p.max_new) == (first.num_beams, first.max_new):
                group.append(p)
            else:
                defer.append(p)
        for p in defer:
            self._beamq.put(p)
        try:
            outs = self._run_beam_batch(group)
            for p, toks in zip(group, outs):
                p.tokens = toks
                p.req_id = -1 - self._beams_served   # beam-lane ids < 0
                self._beams_served += 1
                p.event.set()
        except Exception as e:          # noqa: BLE001 — fail the group
            log.exception("beam lane failed")
            for p in group:
                p.error = f"beam_search: {type(e).__name__}: {e}"
                p.event.set()

    def _run_beam_batch(self, group: list[_Pending]) -> list[list[int]]:
        from avsr_tpu_torch.data.loader import collate, featurize
        from avsr_tpu_torch.infer.generate import beam_search

        cfg, eng = self.cfg, self.engine
        prompt_ids = self.tok.encode(cfg.model.prompt, add_bos=True)
        hb = collate([p.sample for p in group], cfg.data, prompt_ids, self.tok.pad_id)
        out = beam_search(
            eng.params, cfg.model,
            featurize(hb, eng.device, eng.dt, cfg.model),
            max_new_tokens=group[0].max_new or cfg.decode.max_new_tokens,
            num_beams=group[0].num_beams, length_penalty=cfg.decode.length_penalty,
            eos_id=self.tok.eos_id, compute_dtype=eng.dt, use_kernel=eng.use_kernel,
            kv_cache_dtype=cfg.decode.kv_cache_dtype)
        tokens, lens = out.tokens.cpu().numpy(), out.lengths.cpu().numpy()
        return [[int(t) for t in tokens[i, : lens[i]]] for i in range(len(group))]

    # -- request decoding (handler threads: host arrays only) --------------

    def _sample_from_json(self, body: dict) -> Sample:
        from avsr_tpu_torch.data.audio_io import load_audio

        max_samples = self.cfg.data.max_audio_length
        if "audio" in body:
            audio = np.asarray(body["audio"], np.float32)
            if audio.ndim != 1:
                raise ValueError("'audio' must be a flat float list")
            audio = audio[:max_samples]
        elif "audio_b64" in body:
            wav = base64.b64decode(body["audio_b64"])
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(wav)
                f.flush()
                audio = load_audio(f.name, max_samples=max_samples)
        elif "audio_path" in body:
            path = Path(body["audio_path"])
            if not path.is_file():
                raise ValueError(f"audio_path not found: {path}")
            audio = load_audio(path, max_samples=max_samples)
        else:
            raise ValueError("need one of 'audio', 'audio_b64', 'audio_path'")
        rid = f"http/{int(time.time() * 1e3) % 10 ** 9}"
        return Sample(rid, audio, None, "", [self.tok.eos_id])

    def handle_transcribe(self, body: dict) -> tuple[int, dict]:
        try:
            sample = self._sample_from_json(body)
            p = _Pending(
                sample=sample,
                max_new=(int(body["max_new_tokens"]) if "max_new_tokens" in body else None),
                temperature=float(body.get("temperature", 0.0)),
                top_p=float(body.get("top_p", 1.0)),
                adapter=int(body.get("adapter", 0)),
                num_beams=int(body.get("num_beams", 1)))
        except (ValueError, TypeError) as e:
            # bad field types/values (audio shape, non-numeric knobs, ...)
            return 400, {"error": str(e)}
        except Exception as e:
            # undecodable media and friends — still the client's input
            return 400, {"error": f"{type(e).__name__}: {e}"}
        if not (0 <= p.adapter < max(1, self.engine._n_adapters)):
            return 400, {"error": f"adapter {p.adapter} out of range "
                                  f"(bank has {self.engine._n_adapters} adapters)"}
        if p.max_new is not None and p.num_beams == 1:
            err = self.engine.budget_error(p.sample, p.max_new)
            if err:
                return 400, {"error": err}
        if not (1 <= p.num_beams <= 16):
            return 400, {"error": f"num_beams {p.num_beams} out of range [1, 16]"}
        if p.num_beams > 1 and p.temperature > 0.0:
            return 400, {"error": "num_beams > 1 is deterministic search "
                                  "— drop 'temperature' or the beams"}
        if p.num_beams > 1 and p.adapter != 0:
            return 400, {"error": "the beam lane serves the resident base "
                                  "params only (no adapter bank rows)"}
        try:
            timeout = min(float(body.get("timeout_s", self.request_timeout_s)),
                          self.request_timeout_s)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"timeout_s: {e}"}
        (self._beamq if p.num_beams > 1 else self._inq).put(p)
        if not p.event.wait(timeout):
            # reclaim the slot: nobody is left to read the transcript
            p.abandoned = True
            if p.req_id is not None:
                self._cancelq.put(p.req_id)
            return 504, {"error": "timed out", "req_id": p.req_id, "cancelled": True}
        if p.error:
            return 500, {"error": p.error}
        return 200, {"req_id": p.req_id, "text": self.tok.decode(p.tokens),
                     "tokens": p.tokens, "n_tokens": len(p.tokens)}

    def handle_add_adapter(self, body: dict) -> tuple[int, dict]:
        """POST /v1/adapters {"checkpoint": path}: onboard a LoRA tenant
        into the running pool. The checkpoint's LoRA leaves are read to
        the CPU on this handler thread; the scheduler copies them into the
        bank."""
        from avsr_tpu_torch.cli.common import load_adapter

        ck = body.get("checkpoint")
        if not ck or not Path(ck).exists():
            return 400, {"error": f"checkpoint not found: {ck!r}"}
        try:
            adapter = load_adapter(ck)
        except Exception as e:
            return 400, {"error": f"{type(e).__name__}: {e}"}
        op = _AdminAdd(adapter=adapter, key=str(Path(ck).resolve()))
        self._adminq.put(op)
        if not op.event.wait(self.request_timeout_s):
            # the apply may or may not have happened — a retry of the same
            # checkpoint dedups on op.key, so the 504 stays retryable
            op.abandoned = True
            return 504, {"error": "timed out onboarding adapter", "retry_safe": True}
        if op.error:
            return 400, {"error": op.error}
        return 200, {"adapter": op.result, "adapters": self.engine._n_adapters}

    def handle_health(self) -> tuple[int, dict]:
        return 200, {"ok": True,
                     "outstanding": self.engine.outstanding(),
                     "uptime_s": round(time.time() - self.started_at, 1),
                     "model": {"modality": self.cfg.model.modality,
                               "connector": self.cfg.model.connector_type,
                               "slots": self.engine.S,
                               "adapters": self.engine._n_adapters},
                     "stats": self.engine.stats()}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Bind the socket and start the scheduler (which warms the engine
        up first, when asked to) and the HTTP thread; returns once the
        scheduler takes requests."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _reply(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/v1/health":
                    self._reply(*server.handle_health())
                elif self.path == "/v1/stats":
                    self._reply(200, server.engine.stats())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _authed(self) -> bool:
                if server.auth_token is None:
                    return True
                got = self.headers.get("Authorization", "")
                # constant-time compare: '==' stops at the first differing
                # byte and leaks the secret through timing
                return hmac.compare_digest(got.encode(),
                                           f"Bearer {server.auth_token}".encode())

            def do_POST(self):  # noqa: N802
                routes = {"/v1/transcribe": server.handle_transcribe,
                          "/v1/adapters": server.handle_add_adapter}
                handler = routes.get(self.path)
                if handler is None:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                if not self._authed():
                    self._reply(401, {"error": "missing/invalid bearer token"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n < 0:
                        # rfile.read(-1) would read until the client closes
                        # — an unbounded buffer that defeats the cap
                        self._reply(400, {"error": "bad Content-Length"})
                        return
                    if n > server.max_body_bytes:
                        self._reply(413, {"error": f"body {n} bytes > cap "
                                                   f"{server.max_body_bytes}"})
                        return
                    body = json.loads(self.rfile.read(n) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad JSON: {e}"})
                    return
                self._reply(*handler(body))

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]   # resolve port 0
        t_sched = threading.Thread(target=self._scheduler, name="avsr-scheduler",
                                   daemon=True)
        t_http = threading.Thread(target=self._httpd.serve_forever, name="avsr-http",
                                  daemon=True)
        t_sched.start()
        t_http.start()
        self._threads = [t_sched, t_http]
        while not self._ready.wait(0.5):
            if not t_sched.is_alive():
                raise RuntimeError("the scheduler thread died during warmup")
        log.info("serving on http://%s:%d (slots=%d)", self.host, self.port, self.engine.S)

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=60)
        self.engine.close()
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def serve_forever(self) -> None:
        """Block until interrupted (the CLI entry point's main loop)."""
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            log.info("shutting down")
            self.stop()
