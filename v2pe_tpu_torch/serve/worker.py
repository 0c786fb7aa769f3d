"""Model serving worker (port of ``v2pe_tpu/serve/worker.py``).

Stdlib ``http.server`` with the JAX worker's wire protocol:
``/worker_generate_stream`` (b'\\0'-delimited JSON chunks of the cumulative
text), ``/worker_get_status``, ``GET /v1/models`` and ``/v1/chat/completions``
(with ``"stream": true`` as server-sent events ending in ``data: [DONE]``),
controller registration and heartbeat, a semaphore concurrency limit, and
dynamic tiling of base64 images (PIL, imported when an image arrives).
V2PE position ids are passed at serve time. Requests decode through the
port's ``stream_generate`` with the chat model's cache mode, page size and
KV dtype, or, when the worker is given an ``engine``
(``serve/engine.InferenceEngine``), through the continuous-batching engine:
concurrent generations then share one batched decode instead of taking
turns."""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as urlrequest

import numpy as np

from v2pe_tpu_torch.positional import build_v2pe_pos_ids
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig
from v2pe_tpu_torch.infer.streaming import stream_generate
from v2pe_tpu_torch.serve.mm_utils import (KeywordsStoppingCriteria,
                                           load_image_from_base64)

logger = logging.getLogger(__name__)


class ModelWorker:
    def __init__(
        self,
        chat_model: ChatModel,
        *,
        model_name: str = "internvl2-v2pe",
        controller_addr: Optional[str] = None,
        worker_addr: Optional[str] = None,
        limit_model_concurrency: int = 5,
        heartbeat_interval: float = 15.0,
        engine=None,
    ):
        self.model = chat_model
        self.engine = engine
        if engine is not None:
            engine.start()
        self.model_name = model_name
        self.worker_id = str(uuid.uuid4())[:6]
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.limit = limit_model_concurrency
        self.heartbeat_interval = heartbeat_interval
        self._hb_thread = None
        if controller_addr:
            self.register_to_controller()
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True)
            self._hb_thread.start()

    # ----------------------------------------------------- controller plane
    def _post(self, url: str, payload: dict):
        req = urlrequest.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        return urlrequest.urlopen(req, timeout=5)

    def register_to_controller(self):
        logger.info("register to controller %s", self.controller_addr)
        self._post(self.controller_addr + "/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        })

    def _heartbeat_loop(self):
        while True:
            time.sleep(self.heartbeat_interval)
            try:
                self._post(self.controller_addr + "/receive_heart_beat", {
                    "worker_name": self.worker_addr,
                    "queue_length": self.get_queue_length(),
                })
            except Exception as e:
                logger.warning("heartbeat failed: %s", e)

    def get_queue_length(self) -> int:
        return self.limit - self.semaphore._value

    def get_status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.get_queue_length()}

    # ----------------------------------------------------------- generation
    def generate_stream(self, params: dict, meta: Optional[dict] = None):
        """Yields dicts {text, error_code} with the cumulative text.
        ``meta``, when given, is filled with {'prompt_tokens': N} (image tile
        tokens included) and 'completion_tokens' for the OpenAI usage
        block."""
        prompt = params["prompt"]
        images_b64 = params.get("images") or []
        max_new_tokens = int(params.get("max_new_tokens", 256))
        temperature = float(params.get("temperature", 0.0))
        top_p = float(params.get("top_p", 1.0))
        stop_str = params.get("stop")
        max_num = int(params.get("max_num", self.model.cfg.max_dynamic_patch))

        pixel_list, num_patches_list = [], []
        for b64 in images_b64:
            img = load_image_from_base64(b64)
            pv, n = self.model.load_pixels(img, max_num=max_num)
            pixel_list.append(pv)
            num_patches_list.append(n)
        if pixel_list:
            pixels = np.concatenate(pixel_list)
            flags = np.ones((pixels.shape[0],), np.int32)
        else:
            sz = self.model.cfg.force_image_size \
                or self.model.cfg.vision.image_size
            pixels = np.zeros((1, 3, sz, sz), np.float32)
            flags = np.zeros((1,), np.int32)

        query = prompt
        for n in num_patches_list:
            tokens = ("<img>" + "<IMG_CONTEXT>"
                      * self.model.cfg.num_image_token * n + "</img>")
            query = query.replace("<image>", tokens, 1)

        enc = self.model.tokenizer(query)
        ids = np.asarray(enc["input_ids"], np.int64)
        if meta is not None:
            meta["prompt_tokens"] = int(len(ids))
        # V2PE position ids (the reference's serve path omits these)
        if num_patches_list and \
                self.model.cfg.rope_pos_id_version != "default":
            pos = build_v2pe_pos_ids(
                ids, np.ones_like(ids), num_patches_list,
                img_start_id=self.model.img_start_id,
                img_end_id=self.model.img_end_id,
                num_image_token=self.model.cfg.num_image_token,
                version=self.model.cfg.rope_pos_id_version,
                stride=self.model.cfg.rope_pos_id_stride)
        else:
            pos = np.arange(len(ids), dtype=np.float32)

        gc = GenerationConfig(
            max_new_tokens=max_new_tokens,
            do_sample=temperature > 0.0,
            temperature=temperature, top_p=top_p,
            eos_token_ids=tuple(self.model.conv_template.stop_token_ids))

        if isinstance(stop_str, str):
            stop_str = [stop_str]
        stopper = KeywordsStoppingCriteria(
            list(stop_str) if stop_str else [self.model.conv_template.sep])
        stop_ids = set(gc.eos_token_ids)
        keep = []
        if self.engine is not None:
            # continuous batching: this request decodes interleaved with
            # every other in-flight one. Sampling settings are the
            # ENGINE's (per-request max_new_tokens/stop are honored).
            req = self.engine.submit(
                ids, pos,
                pixel_values=np.concatenate(pixel_list) if pixel_list
                else None,
                max_new_tokens=max_new_tokens)
            while True:
                tok = req.token_queue.get()
                if tok is None:
                    if meta is not None:
                        meta["completion_tokens"] = len(keep)
                    if req.error is not None:
                        raise RuntimeError("engine failed") from req.error
                    return
                if int(tok) in stop_ids:
                    continue
                keep.append(int(tok))
                text = self.model.tokenizer.decode(
                    keep, skip_special_tokens=True)
                if meta is not None:
                    meta["completion_tokens"] = len(keep)
                if stopper.should_stop(text):
                    yield {"text": stopper.trim(text), "error_code": 0}
                    return
                yield {"text": text, "error_code": 0}
        for chunk in stream_generate(
                self.model.model, self.model.cfg, gc, ids[None],
                pos[None].astype(np.float32), pixels, flags,
                self.model.img_context_token_id,
                cache_mode=self.model.cache_mode,
                page_size=self.model.page_size,
                kv_dtype=self.model.kv_dtype):
            # re-decode the whole kept sequence every chunk: decoding
            # chunks apart can split a multi-token grapheme
            keep += [int(t) for t in chunk if int(t) not in stop_ids]
            text = self.model.tokenizer.decode(
                keep, skip_special_tokens=True)
            if meta is not None:
                meta["completion_tokens"] = len(keep)
            if stopper.should_stop(text):
                yield {"text": stopper.trim(text), "error_code": 0}
                return
            yield {"text": text, "error_code": 0}

    # ------------------------------------------------- OpenAI-compat surface
    def _openai_to_params(self, body: dict) -> dict:
        """messages[] -> the worker's native generate params.

        Supports string content and the parts form ({type: text} /
        {type: image_url, image_url: {url: "data:image/...;base64,..."}}).
        Each image contributes an '<image>' marker at the head of its
        message's text; alternating user/assistant turns become template
        history; an optional system message overrides the template's
        system line."""
        messages = body.get("messages")
        if not messages:
            raise ValueError("messages required")
        system = None
        turns = []  # (role, text)
        images = []

        def _parts(content):
            if isinstance(content, str):
                return content, []
            texts, imgs = [], []
            for part in content:
                if part.get("type") == "text":
                    texts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = (part.get("image_url") or {}).get("url", "")
                    if "," in url and url.startswith("data:"):
                        imgs.append(url.split(",", 1)[1])
                    else:
                        raise ValueError(
                            "image_url must be a data: URL (no egress)")
            return "\n".join(texts), imgs

        for m in messages:
            role = m.get("role")
            text, imgs = _parts(m.get("content") or "")
            if role == "system":
                system = text
                continue
            if role == "user":
                text = "<image>\n" * len(imgs) + text
                images.extend(imgs)
            turns.append((role, text))

        if not turns or turns[-1][0] != "user":
            raise ValueError("last message must be a user turn")
        history, i = [], 0
        while i + 1 < len(turns):
            if turns[i][0] != "user" or turns[i + 1][0] != "assistant":
                raise ValueError("history must alternate user/assistant")
            history.append((turns[i][1], turns[i + 1][1]))
            i += 2
        question = turns[-1][1]

        conv = self.model.conv_template.copy()
        conv.system_message = system if system is not None \
            else self.model.system_message
        for old_q, old_a in history:
            conv.append_message(conv.roles[0], old_q)
            conv.append_message(conv.roles[1], old_a)
        conv.append_message(conv.roles[0], question)
        conv.append_message(conv.roles[1], None)

        stop = body.get("stop")
        return {
            "prompt": conv.get_prompt(),  # '<image>' markers intact —
            # generate_stream splices the tile token spans per image
            "images": images,
            "max_new_tokens": int(body.get("max_tokens")
                                  or body.get("max_completion_tokens")
                                  or 256),
            "temperature": float(body.get("temperature") or 0.0),
            "top_p": float(body.get("top_p") or 1.0),
            "stop": stop,
        }

    def chat_completion(self, body: dict):
        """Returns (final_record, stream_iterator). Exactly one is consumed:
        stream=False -> drain internally and return the completion record;
        stream=True -> yield OpenAI chat.completion.chunk dicts."""
        params = self._openai_to_params(body)
        created = int(time.time())
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        model_name = body.get("model") or self.model_name

        stop = params.get("stop")
        keywords = ([stop] if isinstance(stop, str) else list(stop)) \
            if stop else [self.model.conv_template.sep]

        def _safe_len(text: str) -> int:
            # hold back any suffix that is a proper prefix of a stop
            # keyword — once streamed, a delta cannot be retracted when
            # the stopper later trims the matched keyword
            held = 0
            for kw in keywords:
                for n in range(min(len(kw) - 1, len(text)), 0, -1):
                    if text.endswith(kw[:n]):
                        held = max(held, n)
                        break
            return len(text) - held

        def chunks():
            sent = 0
            yield {"id": cid, "object": "chat.completion.chunk",
                   "created": created, "model": model_name,
                   "choices": [{"index": 0,
                                "delta": {"role": "assistant",
                                          "content": ""},
                                "finish_reason": None}]}
            final, meta = "", {}
            for out in self.generate_stream(params, meta=meta):
                if out.get("error_code"):
                    raise RuntimeError(out.get("text", "generation error"))
                final = out["text"]
                safe = _safe_len(final)
                if safe > sent:
                    yield {"id": cid, "object": "chat.completion.chunk",
                           "created": created, "model": model_name,
                           "choices": [{"index": 0,
                                        "delta":
                                            {"content": final[sent:safe]},
                                        "finish_reason": None}]}
                    sent = safe
            if len(final) > sent:  # flush the held-back tail (post-trim)
                yield {"id": cid, "object": "chat.completion.chunk",
                       "created": created, "model": model_name,
                       "choices": [{"index": 0,
                                    "delta": {"content": final[sent:]},
                                    "finish_reason": None}]}
            n_out = meta.get("completion_tokens", 0)
            reason = "length" if n_out >= params["max_new_tokens"] \
                else "stop"
            yield {"id": cid, "object": "chat.completion.chunk",
                   "created": created, "model": model_name,
                   "choices": [{"index": 0, "delta": {},
                                "finish_reason": reason}]}

        if body.get("stream"):
            return None, chunks()

        final, reason, meta = "", "stop", {}
        for out in self.generate_stream(params, meta=meta):
            if out.get("error_code"):
                raise RuntimeError(out.get("text", "generation error"))
            final = out["text"]
        n_prompt = meta.get(
            "prompt_tokens",
            len(self.model.tokenizer(params["prompt"])["input_ids"]))
        n_out = meta.get("completion_tokens", 0)
        if n_out >= params["max_new_tokens"]:
            reason = "length"
        return {"id": cid, "object": "chat.completion", "created": created,
                "model": model_name,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": final},
                             "finish_reason": reason}],
                "usage": {"prompt_tokens": n_prompt,
                          "completion_tokens": n_out,
                          "total_tokens": n_prompt + n_out}}, None

    # ---------------------------------------------------------- http server
    def make_server(self, host: str = "0.0.0.0", port: int = 40000):
        worker = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _json_body(self):
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_GET(self):
                if self.path == "/v1/models":
                    body = json.dumps({
                        "object": "list",
                        "data": [{"id": worker.model_name,
                                  "object": "model",
                                  "owned_by": "v2pe-tpu"}]}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path == "/v1/chat/completions":
                    try:
                        body = self._json_body()
                    except Exception:
                        body = None
                    if body is None:
                        self.send_response(400)
                        self.end_headers()
                        return
                    try:
                        with worker.semaphore:
                            record, stream = worker.chat_completion(body)
                            if stream is None:
                                payload = json.dumps(record).encode()
                                self.send_response(200)
                                self.send_header("Content-Type",
                                                 "application/json")
                                self.send_header("Content-Length",
                                                 str(len(payload)))
                                self.end_headers()
                                self.wfile.write(payload)
                            else:
                                self.send_response(200)
                                self.send_header("Content-Type",
                                                 "text/event-stream")
                                self.send_header("Cache-Control", "no-cache")
                                self.end_headers()
                                try:
                                    for chunk in stream:
                                        self.wfile.write(
                                            b"data: "
                                            + json.dumps(chunk).encode()
                                            + b"\n\n")
                                except Exception as e:
                                    # headers are gone — the error must
                                    # ride the stream, not a status line
                                    logger.exception(
                                        "mid-stream generation failed")
                                    self.wfile.write(
                                        b"data: " + json.dumps(
                                            {"error": {
                                                "message": str(e),
                                                "type": "server_error"}}
                                        ).encode() + b"\n\n")
                                self.wfile.write(b"data: [DONE]\n\n")
                    except ValueError as e:
                        payload = json.dumps(
                            {"error": {"message": str(e),
                                       "type": "invalid_request_error"}}
                        ).encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length",
                                         str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                    except Exception as e:
                        logger.exception("chat completion failed")
                        payload = json.dumps(
                            {"error": {"message": str(e),
                                       "type": "server_error"}}).encode()
                        self.send_response(500)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length",
                                         str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                elif self.path == "/worker_generate_stream":
                    params = self._json_body()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.end_headers()
                    with worker.semaphore:
                        try:
                            for out in worker.generate_stream(params):
                                self.wfile.write(
                                    json.dumps(out).encode() + b"\0")
                        except Exception as e:
                            logger.exception("generate failed")
                            self.wfile.write(json.dumps({
                                "text": f"server error: {e}",
                                "error_code": 1}).encode() + b"\0")
                elif self.path == "/worker_get_status":
                    body = json.dumps(worker.get_status()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

        return ThreadingHTTPServer((host, port), Handler)

    def serve_forever(self, host="0.0.0.0", port=40000):
        server = self.make_server(host, port)
        logger.info("worker %s listening on %s:%d", self.worker_id, host,
                    port)
        server.serve_forever()
