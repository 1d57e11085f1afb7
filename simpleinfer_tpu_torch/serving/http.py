"""HTTP front-end for the continuous-batching service: the counterpart of
simpleinfer_tpu/serving/http.py, with the same routes and codes, on the
standard library only.

- ``POST /v1/infer``  — one inference item per request. Body is either
  a ``.npy`` array (``Content-Type: application/x-npy``) or JSON
  ``{"input": <nested list>}``. The response mirrors the request
  encoding. Concurrent requests are merged into device batches by the
  BatchingService — the HTTP layer adds no batching logic of its own.
- ``POST /v1/detect`` — one HWC image (``.npy`` or JSON ``{"image":
  ...}``), letterboxed in the handler thread and decoded server-side;
  responds with JSON detections ``{"detections": [{box, score,
  class_id, class_name}], "count": N}``. Query params ``?conf=&iou=``
  set host-decode thresholds (ignored when the service decodes on the
  card via ``device_postprocess=decode_device(...)``).
- ``POST /v1/generate`` — JSON ``{"prompt": [ids], "max_new", "eos_id",
  "temperature", "top_k", "top_p", "timeout_s", "priority"}`` through
  the attached GenerationService (or TieredGenerationService); replies
  ``{"ids": [prompt + generated], "prompt_len": P}``. With ``"stream":
  true`` the reply is Server-Sent Events: ``data: {"token": id}`` per
  token, then ``data: {"done": true, "ids": [...], "prompt_len": P}``;
  a client that hangs up mid-stream cancels its request (its row is
  freed at the scheduler's next drain). 400 on a malformed body, or
  when no generation service is attached.
- ``GET /v1/stats``   — scheduler statistics as JSON; pass ``?slo_ms=N``
  to include the per-bucket SLO report. A generation service's counters
  are the whole reply on a generation-only server, under
  ``"generation"`` beside a BatchingService's.
- ``GET /metrics``    — the same counters in Prometheus text exposition
  format, for scrape-based monitoring.
- ``GET /healthz``    — liveness probe.

Every handler thread blocks on its request's Future while the scheduler
thread owns the card, so HTTP concurrency (ThreadingHTTPServer, one
thread per connection) translates directly into batch occupancy. The
native letterbox releases the interpreter lock, so the handler threads
letterbox in parallel with the scheduler's launches. Item arrays are
validated against the engine's per-item input shape up front, returning
400 before anything reaches the queue.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

NPY_CONTENT_TYPE = "application/x-npy"
_MAX_BODY = 256 * 1024 * 1024


class InferenceServer:
    """Serve a started BatchingService and / or generation service over
    HTTP.

    Usage:
        svc = BatchingService(engine).start()
        server = InferenceServer(svc).start()     # port=0 -> ephemeral
        ... server.address ...
        server.stop(); svc.stop()
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 8000,
                 request_timeout_s: float = 120.0, gen_service=None):
        """`service`: a started BatchingService (/v1/infer, /v1/detect),
        or None when only serving generation. `gen_service`: a started
        serving.llm.GenerationService or TieredGenerationService
        (/v1/generate)."""
        if service is None and gen_service is None:
            raise ValueError("need a BatchingService, a "
                             "GenerationService, or both")
        self.service = service
        self.gen_service = gen_service
        self.request_timeout_s = request_timeout_s
        self._item_shape = (self._resolve_item_shape(service)
                            if service is not None else None)
        self._u8_scale = float(getattr(
            service.engine.config, "u8_scale", 1.0 / 255.0)) \
            if service is not None else 1.0 / 255.0
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @staticmethod
    def _resolve_item_shape(service):
        """Per-item (batch-less) input shape from the engine program."""
        for spec in service.engine.program.inputs:
            if spec.name == service.input_name:
                return tuple(spec.shape[1:])
        raise ValueError(f"input {service.input_name!r} not in program")

    @property
    def address(self) -> tuple:
        return self._httpd.server_address

    def start(self) -> "InferenceServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="si-http")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=10)
        self._httpd.server_close()
        self._thread = None

    # ---- request handling (called from handler threads) ----------------
    def infer(self, array: np.ndarray) -> np.ndarray:
        if self.service is None:
            raise ValueError("this server only exposes /v1/generate")
        if tuple(array.shape) != self._item_shape:
            raise ValueError(
                f"expected item shape {self._item_shape}, "
                f"got {tuple(array.shape)}")
        # Normalize dtype HERE: the batcher stacks concurrent items, so a
        # uint8 item co-batched with float32 ones would be promoted
        # UNSCALED (the result would depend on what else is in flight).
        # uint8 gets the engine's u8_scale normalization on the host
        # instead — the math of the device-side u8 path, deterministic
        # whatever it is batched with.
        if array.dtype == np.uint8:
            array = array.astype(np.float32) * self._u8_scale
        elif array.dtype != np.float32:
            try:
                array = array.astype(np.float32)
            except (TypeError, ValueError) as e:
                raise ValueError(f"unsupported input dtype "
                                 f"{array.dtype}: {e}") from e
        fut = self.service.submit(array)
        # the service fetches bf16 outputs as float32 (portable on the
        # wire: numpy has no bfloat16)
        return np.asarray(fut.result(timeout=self.request_timeout_s))

    def _gen_args(self, payload) -> tuple:
        """(prompt, keyword arguments of submit) of a /v1/generate body;
        ValueError on a malformed one."""
        if self.gen_service is None:
            raise ValueError("no generation service attached "
                             "(serve a causal LM with --generate)")
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        prompt = payload.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise ValueError('body needs "prompt": [token ids]')
        eos = payload.get("eos_id")
        timeout_s = payload.get("timeout_s")
        try:
            return prompt, dict(
                max_new=int(payload.get("max_new", 32)),
                eos_id=int(eos) if eos is not None else None,
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                timeout_s=float(timeout_s) if timeout_s is not None
                else None,
                priority=int(payload.get("priority", 0)))
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad generation parameter: {e}") from None

    def generate(self, payload: dict) -> dict:
        """One /v1/generate body -> {"ids", "prompt_len"}; waits for the
        request's end."""
        prompt, kw = self._gen_args(payload)
        fut = self.gen_service.submit(prompt, **kw)
        ids = fut.result(timeout=self.request_timeout_s)
        return {"ids": np.asarray(ids).tolist(), "prompt_len": len(prompt)}

    def generate_stream(self, payload: dict):
        """A /v1/generate body with "stream": true -> the service's
        StreamHandle."""
        prompt, kw = self._gen_args(payload)
        return self.gen_service.submit_stream(prompt, **kw)

    def detect(self, image: np.ndarray, conf: float, iou: float) -> list:
        """One HWC image -> list of detection dicts: letterbox to the
        service's item size, submit, decode. Works with either service
        shape: raw head rows (host decode with the given thresholds) or
        device-decoded [max_det, 6] rows (thresholds were fixed at
        BatchingService(device_postprocess=decode_device(...)) time —
        conf/iou query params are ignored then)."""
        from ..zoo.detect import (decode_predictions,
                                  detections_from_decoded, letterbox)

        if self.service is None:
            raise ValueError("this server only exposes /v1/generate")
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(
                f"detect expects an HWC 3-channel image, got "
                f"{tuple(image.shape)}")
        size = self._item_shape[0]
        if len(self._item_shape) != 3 or self._item_shape[:2] != (size,
                                                                  size):
            raise ValueError(
                f"service input {self._item_shape} is not a square "
                f"image — /v1/detect needs a detection model")
        if image.dtype != np.uint8:
            image = np.clip(image, 0, 255).astype(np.uint8)
        canvas, lb = letterbox(image, size)
        fut = self.service.submit(canvas)
        rows = np.asarray(fut.result(timeout=self.request_timeout_s))
        # branch on how the SERVICE was configured, not on row shape —
        # a 1-class v5 / 2-class v8 raw head is also 6 columns wide
        if self.service.device_post is not None:
            dets = detections_from_decoded(rows, lb,
                                           image_shape=image.shape)
        else:
            dets = decode_predictions(rows, lb, conf, iou,
                                      image_shape=image.shape,
                                      head=self._detect_head)
        return [{"box": [float(v) for v in d.box],
                 "score": float(d.score), "class_id": int(d.class_id),
                 "class_name": d.class_name} for d in dets]

    @property
    def _detect_head(self) -> str:
        types = {i.type for i in self.service.engine.program.impls}
        return "v8" if "models.yolo.DetectV8" in types else "v5"

    def gen_stats_dict(self) -> dict:
        g = self.gen_service.stats
        return {"requests": g.requests, "completed": g.completed,
                "steps": g.steps, "capped_steps": g.capped_steps,
                "cancelled": g.cancelled, "timed_out": g.timed_out,
                "tokens_out": g.tokens_out,
                "mean_occupancy": g.mean_occupancy,
                "mean_latency_ms": g.mean_latency_ms}

    def stats_dict(self, slo_ms: float | None = None) -> dict:
        if self.service is None:
            return self.gen_stats_dict()
        s = self.service.stats
        out = {
            "requests": s.requests,
            "batches": s.batches,
            "padded_items": s.padded_items,
            "mean_latency_ms": s.mean_latency_ms,
            "mean_batch_occupancy": s.mean_batch_occupancy,
            "batches_per_engine": list(s.batches_per_engine),
            "per_bucket": {
                str(b): {"batches": bs.batches, "items": bs.items,
                         "mean_latency_ms": bs.mean_latency_ms,
                         "max_latency_ms": 1e3 * bs.max_latency_s}
                for b, bs in sorted(s.per_bucket.items())},
            "item_shape": list(self._item_shape),
        }
        if slo_ms is not None:
            out["slo"] = s.slo_report(slo_ms)
        if self.gen_service is not None:
            out["generation"] = self.gen_stats_dict()
        return out

    def gen_metrics_lines(self) -> list:
        g = self.gen_service.stats
        return [
            "# TYPE si_gen_requests_total counter",
            f"si_gen_requests_total {g.requests}",
            "# TYPE si_gen_tokens_total counter",
            f"si_gen_tokens_total {g.tokens_out}",
            "# TYPE si_gen_steps_total counter",
            f"si_gen_steps_total {g.steps}",
            "# TYPE si_gen_capped_steps_total counter",
            f"si_gen_capped_steps_total {g.capped_steps}",
            "# TYPE si_gen_cancelled_total counter",
            f"si_gen_cancelled_total {g.cancelled}",
            "# TYPE si_gen_timed_out_total counter",
            f"si_gen_timed_out_total {g.timed_out}",
            "# TYPE si_gen_slot_occupancy gauge",
            f"si_gen_slot_occupancy {g.mean_occupancy:.6f}",
        ]

    def metrics_text(self) -> str:
        """The counters in Prometheus text exposition format."""
        if self.service is None:
            return "\n".join(self.gen_metrics_lines()) + "\n"
        s = self.service.stats
        lines = [
            "# TYPE si_requests_total counter",
            f"si_requests_total {s.requests}",
            "# TYPE si_batches_total counter",
            f"si_batches_total {s.batches}",
            "# TYPE si_padded_items_total counter",
            f"si_padded_items_total {s.padded_items}",
            "# TYPE si_request_latency_seconds_sum counter",
            f"si_request_latency_seconds_sum {s.total_latency_s:.9f}",
            "# TYPE si_batch_time_seconds_sum counter",
            f"si_batch_time_seconds_sum {s.total_batch_time_s:.9f}",
            "# TYPE si_batch_occupancy gauge",
            f"si_batch_occupancy {s.mean_batch_occupancy:.6f}",
        ]
        lines.append("# TYPE si_bucket_items_total counter")
        for b, bs in sorted(s.per_bucket.items()):
            lines.append(f'si_bucket_items_total{{bucket="{b}"}} '
                         f"{bs.items}")
        lines.append("# TYPE si_bucket_latency_seconds_max gauge")
        for b, bs in sorted(s.per_bucket.items()):
            lines.append(f'si_bucket_latency_seconds_max{{bucket="{b}"}} '
                         f"{bs.max_latency_s:.9f}")
        for i, n in enumerate(s.batches_per_engine):
            lines.append(f'si_engine_batches_total{{engine="{i}"}} {n}')
        if self.gen_service is not None:
            lines += self.gen_metrics_lines()
        return "\n".join(lines) + "\n"


def _make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # silence per-request stderr lines (serving logs go via stats)
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._reply_json(200, {"status": "ok"})
            elif path == "/metrics":
                self._reply(200, server.metrics_text().encode(),
                            "text/plain; version=0.0.4")
            elif path == "/v1/stats":
                slo_ms = None
                for part in query.split("&"):
                    if part.startswith("slo_ms="):
                        try:
                            slo_ms = float(part.split("=", 1)[1])
                        except ValueError:
                            self._reply_json(
                                400, {"error": "bad slo_ms"})
                            return
                self._reply_json(200, server.stats_dict(slo_ms))
            else:
                self._reply_json(404, {"error": f"no route {path}"})

        def _generate_sse(self, payload: dict) -> None:
            """One generation as Server-Sent Events: `data: {"token":
            id}` per generated token (block granularity), then `data:
            {"done": true, "ids": [...], "prompt_len": P}`. No
            Content-Length: the connection closes at the stream's end. A
            write that fails (the client hung up) cancels the request."""
            try:
                handle = server.generate_stream(payload)
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.close_connection = True
            self.end_headers()
            try:
                for tok in handle:
                    self.wfile.write(
                        f'data: {{"token": {tok}}}\n\n'.encode())
                    self.wfile.flush()
                ids = handle.result(timeout=server.request_timeout_s)
                done = json.dumps({
                    "done": True, "ids": np.asarray(ids).tolist(),
                    "prompt_len": len(payload["prompt"])})
                self.wfile.write(f"data: {done}\n\n".encode())
                self.wfile.flush()
            except ConnectionError:
                # the client went away mid-stream (broken pipe, reset;
                # not OSError: a deadline's TimeoutError is one): free
                # its row instead of decoding the rest of max_new for
                # nobody
                server.gen_service.cancel(handle.future)
            except Exception as e:  # noqa: BLE001 — backend error
                err = json.dumps({"error": f"{type(e).__name__}: {e}"})
                try:
                    self.wfile.write(f"data: {err}\n\n".encode())
                    self.wfile.flush()
                except OSError:
                    pass

        def do_POST(self):  # noqa: N802
            path, _, query = self.path.partition("?")
            if path not in ("/v1/infer", "/v1/detect",
                            "/v1/generate"):
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                # body was never read: the keep-alive connection is
                # desynchronized, so force-close it
                self.close_connection = True
                self._reply_json(400, {"error": "bad Content-Length"})
                return
            if not 0 < length <= _MAX_BODY:
                self.close_connection = True
                self._reply_json(400, {"error": "body required "
                                       f"(max {_MAX_BODY} bytes)"})
                return
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if path == "/v1/generate":
                self._post_generate(body, ctype)
                return
            try:
                if ctype == NPY_CONTENT_TYPE:
                    arr = np.load(io.BytesIO(body), allow_pickle=False)
                else:
                    key = "image" if path == "/v1/detect" else "input"
                    arr = np.asarray(json.loads(body)[key])
                    if path != "/v1/detect":
                        arr = arr.astype(np.float32)
            except Exception as e:  # noqa: BLE001 — client error
                self._reply_json(400, {"error": f"bad body: {e}"})
                return
            if path == "/v1/detect":
                from urllib.parse import parse_qs

                q = parse_qs(query)

                def qf(key, default):
                    if key not in q:
                        return default
                    try:
                        return float(q[key][0])
                    except (IndexError, ValueError):
                        raise ValueError(
                            f"bad query param {key}={q[key]!r}") from None

                try:
                    dets = server.detect(arr, qf("conf", 0.25),
                                         qf("iou", 0.45))
                except ValueError as e:
                    self._reply_json(400, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 — backend error
                    self._reply_json(500,
                                     {"error": f"{type(e).__name__}: {e}"})
                    return
                self._reply_json(200, {"detections": dets,
                                       "count": len(dets)})
                return
            try:
                out = server.infer(arr)
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — backend error
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            if ctype == NPY_CONTENT_TYPE:
                buf = io.BytesIO()
                np.save(buf, out, allow_pickle=False)
                self._reply(200, buf.getvalue(), NPY_CONTENT_TYPE)
            else:
                self._reply_json(200, {"output": out.tolist(),
                                       "shape": list(out.shape)})

        def _post_generate(self, body: bytes, ctype: str) -> None:
            if ctype == NPY_CONTENT_TYPE:
                self._reply_json(400, {"error": "/v1/generate takes a "
                                       "JSON body"})
                return
            try:
                payload = json.loads(body)
            except Exception as e:  # noqa: BLE001 — client error
                self._reply_json(400, {"error": f"bad body: {e}"})
                return
            if isinstance(payload, dict) and payload.get("stream"):
                self._generate_sse(payload)
                return
            try:
                out = server.generate(payload)
            except ValueError as e:
                self._reply_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — backend error
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply_json(200, out)

    return Handler
