"""The port's serving surfaces over a paged cache against the JAX package on
the CPU: ChatModel.chat/batch_chat, a three-turn ChatSession with two
images, and the HTTP ModelWorker (status, the generate stream with and
without an image, /v1/models, /v1/chat/completions with and without SSE).
Both sides hold the same fp32 weights; greedy text and every response must
be identical (OpenAI ids and timestamps aside)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.infer.chat import ChatModel as JaxChatModel
from v2pe_tpu.infer.generate import GenerationConfig as JaxGenerationConfig
from v2pe_tpu.infer.session import ChatSession as JaxChatSession
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu.serve.worker import ModelWorker as JaxModelWorker
from v2pe_tpu_torch.infer.chat import ChatModel
from v2pe_tpu_torch.infer.generate import GenerationConfig
from v2pe_tpu_torch.infer.session import ChatSession
from v2pe_tpu_torch.models.params import from_jax_params
from v2pe_tpu_torch.serve.mm_utils import image_to_base64
from v2pe_tpu_torch.serve.worker import ModelWorker

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config


@pytest.fixture(scope="module")
def chats():
    """(JAX ChatModel, port ChatModel), both paged with pages of 8 tokens,
    over the same weights; the wqkv kernel is sharpened so that the greedy
    tokens depend on the positions."""
    tok = _toy_tokenizer()
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=32,
                      intermediate_size=64, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2, max_dynamic_patch=4)
    params = jax_init(jax.random.PRNGKey(4), cfg)
    layers = dict(params["llm"]["layers"])
    layers["wqkv_kernel"] = layers["wqkv_kernel"] * 30.0
    params = {**params, "llm": {**params["llm"], "layers": layers}}
    pcfg = port_config(cfg)  # the port's own config class, same fields
    model = from_jax_params(jax.tree.map(np.asarray, params), pcfg)
    return (JaxChatModel(params, cfg, tok, attn_impl="jnp",
                         cache_mode="paged", page_size=8),
            ChatModel(model, pcfg, tok, cache_mode="paged", page_size=8))


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), dtype=np.uint8))


def test_paged_chat_and_batch_chat_match_jax(chats):
    jchat, tchat = chats
    pixels, n = tchat.load_pixels(_image(0, 80, 120), max_num=4)
    got = tchat.chat(pixels, "What is this?", GenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    want = jchat.chat(pixels, "What is this?", JaxGenerationConfig(
        max_new_tokens=8), return_history=True, num_patches_list=[n])
    assert got == want
    qs = ["Say A.", "Count to three, please."]
    assert tchat.batch_chat(None, qs, GenerationConfig(max_new_tokens=6)) \
        == jchat.batch_chat(None, qs, JaxGenerationConfig(max_new_tokens=6))


def test_session_three_turns_two_images_match_jax(chats):
    """Turn 1 prefills into an empty pool, turns 2 and 3 prefill only their
    suffix over the pool (the paged prefill kernel's path); every reply
    equals the JAX session's."""
    jchat, tchat = chats
    img1, img2 = _image(1, 64, 80), _image(2, 80, 64)
    kw = dict(max_len=2048, page_size=8, chunk_multiple=64)
    jsess, tsess = JaxChatSession(jchat, **kw), ChatSession(tchat, **kw)
    turns = [(img1, "One."), (img2, "Two."), (None, "Three?")]
    for img, q in turns:
        pv = None if img is None else tchat.load_pixels(img)[0]
        want = jsess.send(pv, q, JaxGenerationConfig(max_new_tokens=5))
        got = tsess.send(pv, q, GenerationConfig(max_new_tokens=5))
        assert got == want, q
    assert tsess.consumed == jsess.consumed > 0
    assert int(tsess.cache.lengths[0]) == int(jsess.cache.lengths[0])
    # a speculative turn is ported: the plain turn's reply
    want = jsess.send(None, "Again?", JaxGenerationConfig(
        max_new_tokens=5, speculative_k=2))
    assert tsess.send(None, "Again?", GenerationConfig(
        max_new_tokens=5, speculative_k=2)) == want


# ---------------------------------------------------------------- worker


@pytest.fixture(scope="module")
def servers(chats):
    """The JAX worker and the port's, each on a free local port."""
    jchat, tchat = chats
    urls, running = [], []
    for worker in (JaxModelWorker(jchat, model_name="tiny"),
                   ModelWorker(tchat, model_name="tiny")):
        server = worker.make_server(host="127.0.0.1", port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        urls.append(f"http://127.0.0.1:{server.server_address[1]}")
        running.append(server)
    yield urls
    for server in running:
        server.shutdown()
        server.server_close()


def _post(url, body, raw=False):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        data = r.read()
        return (data, r.headers["Content-Type"]) if raw else json.loads(data)


def _both(servers, fn):
    want, got = (fn(url) for url in servers)
    return want, got


def _strip_ids(record):
    return {k: v for k, v in record.items() if k not in ("id", "created")}


def test_worker_status_matches_jax(servers):
    want, got = _both(servers, lambda u: _post(u + "/worker_get_status", {}))
    assert got == want and got["model_names"] == ["tiny"]


def _stream_chunks(url, payload):
    raw, _ = _post(url + "/worker_generate_stream", payload, raw=True)
    return [json.loads(c) for c in raw.split(b"\0") if c]


def test_worker_generate_stream_text_matches_jax(servers):
    payload = {"prompt": "<|im_start|>user\nCount to three.<|im_end|>"
                         "<|im_start|>assistant\n",
               "max_new_tokens": 12, "temperature": 0.0}
    want, got = _both(servers, lambda u: _stream_chunks(u, payload))
    assert got == want
    assert all(c["error_code"] == 0 for c in got) and len(got) >= 2


def test_worker_generate_stream_image_matches_jax(servers):
    """An image over PIL: base64 decode, dynamic tiles, V2PE positions."""
    payload = {"prompt": "<|im_start|>user\n<image>\nWhat is this?<|im_end|>"
                         "<|im_start|>assistant\n",
               "images": [image_to_base64(_image(0, 80, 120))],
               "max_new_tokens": 6, "temperature": 0.0}
    want, got = _both(servers, lambda u: _stream_chunks(u, payload))
    assert got == want and got[-1]["error_code"] == 0


def test_openai_models_route_matches_jax(servers):
    def fetch(url):
        with urllib.request.urlopen(url + "/v1/models") as r:
            return json.loads(r.read())

    want, got = _both(servers, fetch)
    assert got == want and got["data"][0]["id"] == "tiny"


def test_openai_chat_completion_matches_jax(servers):
    data_url = "data:image/png;base64," + image_to_base64(_image(3, 64, 64))
    body = {"model": "tiny", "messages": [
        {"role": "system", "content": "Be terse."},
        {"role": "user", "content": [
            {"type": "text", "text": "Describe the image."},
            {"type": "image_url", "image_url": {"url": data_url}}]},
        {"role": "assistant", "content": "A picture."},
        {"role": "user", "content": "Again?"}],
        "max_tokens": 6, "temperature": 0.0}
    want, got = _both(servers,
                      lambda u: _post(u + "/v1/chat/completions", body))
    assert _strip_ids(got) == _strip_ids(want)
    assert got["object"] == "chat.completion"
    # malformed (ends with an assistant turn): 400 on both
    bad = {"messages": [{"role": "assistant", "content": "x"}]}
    for url in servers:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/chat/completions", bad)
        assert e.value.code == 400


def test_openai_chat_completion_stream_matches_jax(servers):
    """stream=true: the same SSE chunks, ending in data: [DONE]."""
    body = {"messages": [{"role": "user", "content": "Tell me a story."}],
            "max_tokens": 8, "stream": True}

    def events(url):
        raw, ctype = _post(url + "/v1/chat/completions", body, raw=True)
        assert ctype.startswith("text/event-stream")
        lines = [ln[len("data: "):] for ln in raw.decode().split("\n\n")
                 if ln.startswith("data: ")]
        assert lines[-1] == "[DONE]"
        return [_strip_ids(json.loads(x)) for x in lines[:-1]]

    want, got = _both(servers, events)
    assert got == want
    assert got[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_worker_refuses_the_engine(chats):
    """What is not an engine is refused; an InferenceEngine is started
    (its routes are held against JAX's in test_torch_engine.py)."""
    from v2pe_tpu_torch.serve.engine import InferenceEngine

    with pytest.raises(AttributeError):
        ModelWorker(chats[1], engine=object())
    engine = InferenceEngine(chats[1], max_rows=1, max_len=64, page_size=8)
    try:
        assert ModelWorker(chats[1], engine=engine).engine is engine
        assert engine._thread is not None and engine._thread.is_alive()
    finally:
        engine.stop()
