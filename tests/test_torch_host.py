"""The port's own copies of the host modules (configs, V2PE position ids,
chat templates, tiling and transforms, preprocessing, datasets, sample
packing, the synthetic batch, the native image ops) against the JAX
package's originals on seeded inputs: every output equal, bit for bit. And
the port imports without the JAX package: every module of
``v2pe_tpu_torch`` and ``chip_smoke.py`` import in a process in which
``jax`` and ``v2pe_tpu`` cannot be imported at all."""

import dataclasses
import json
import pathlib
import pkgutil
import random
import subprocess
import sys

import numpy as np
import pytest

import v2pe_tpu_torch
from v2pe_tpu import positional as jpos
from v2pe_tpu.core import config as jconfig
from v2pe_tpu.data import constants as jconstants
from v2pe_tpu.data import conversation as jconv
from v2pe_tpu.data import datasets as jdatasets
from v2pe_tpu.data import packing as jpacking
from v2pe_tpu.data import preprocess as jpre
from v2pe_tpu.data import tiling as jtiling
from v2pe_tpu.data import transforms as jtransforms
from v2pe_tpu.evalkit import mm_niah_long as jniah
from v2pe_tpu.train import synth as jsynth
from v2pe_tpu_torch import native as tnative
from v2pe_tpu_torch import positional as tpos
from v2pe_tpu_torch.core import config as tconfig
from v2pe_tpu_torch.data import constants as tconstants
from v2pe_tpu_torch.data import conversation as tconv
from v2pe_tpu_torch.data import datasets as tdatasets
from v2pe_tpu_torch.data import object_store as tstore
from v2pe_tpu_torch.data import packing as tpacking
from v2pe_tpu_torch.data import preprocess as tpre
from v2pe_tpu_torch.data import tiling as ttiling
from v2pe_tpu_torch.data import transforms as ttransforms
from v2pe_tpu_torch.evalkit import mm_niah_long as tniah
from v2pe_tpu_torch.train import synth as tsynth

from .test_data_pipeline import _toy_tokenizer
from .torch_parity import port_config

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- imports


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        v2pe_tpu_torch.__path__, "v2pe_tpu_torch."))


BLOCKED_IMPORT = """
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "v2pe_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "v2pe_tpu", "PIL", "transformers",
              "tokenizers"))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_every_port_module_imports_with_jax_and_the_jax_package_blocked():
    """Also no PIL, transformers or tokenizers at import: the card's machine
    may lack them."""
    names = _port_modules()
    assert {"v2pe_tpu_torch.core.config", "v2pe_tpu_torch.data.datasets",
            "v2pe_tpu_torch.native", "v2pe_tpu_torch.positional.v2pe",
            "v2pe_tpu_torch.ops.quantized_matmul",
            "v2pe_tpu_torch.train.synth", "v2pe_tpu_torch.parallel",
            "v2pe_tpu_torch.parallel.context", "v2pe_tpu_torch.parallel.ring",
            "v2pe_tpu_torch.parallel.ring_fused",
            "v2pe_tpu_torch.parallel.ulysses",
            "v2pe_tpu_torch.parallel.shard_attn",
            "v2pe_tpu_torch.parallel.bootstrap", "v2pe_tpu_torch.parallel.mesh",
            "v2pe_tpu_torch.parallel.pipeline",
            "v2pe_tpu_torch.evalkit",
            "v2pe_tpu_torch.evalkit.mm_niah_long",
            "v2pe_tpu_torch.evalkit.cli", "v2pe_tpu_torch.data.validate",
            "v2pe_tpu_torch.models.safetensors_io",
            "v2pe_tpu_torch.models.export",
            "v2pe_tpu_torch.tools.export_hf",
            "v2pe_tpu_torch.tools.token_count",
            "v2pe_tpu_torch.tools.test_image_patch",
            "v2pe_tpu_torch.tools.inference_test",
            "v2pe_tpu_torch.scripts.bench_decode",
            "v2pe_tpu_torch.scripts.bench_train_remat",
            "v2pe_tpu_torch.models.lora", "v2pe_tpu_torch.models.compress_seq",
            "v2pe_tpu_torch.models.sequence_classification",
            "v2pe_tpu_torch.utils", "v2pe_tpu_torch.utils.diagnostics",
            "v2pe_tpu_torch.utils.profiling",
            *(f"v2pe_tpu_torch.evalkit.{m}" for m in EVALKIT_COPIES
              if m != "__init__")} <= set(names)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT, "chip_smoke", *names],
        capture_output=True, text=True, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) == len(names) + 1


EVALKIT_COPIES = ("__init__", "runner", "metrics", "report", "general", "vqa",
                  "vqa_driver", "longvqa", "longvqa_driver", "milebench",
                  "milebench_adapter", "mm_niah", "mmbench", "mmmu", "pope",
                  "seed", "scienceqa", "video", "gpt_judge")


@pytest.mark.parametrize("path", [f"evalkit/{m}.py" for m in EVALKIT_COPIES]
                         + ["data/validate.py"])
def test_host_copy_is_its_original_with_imports_retargeted(path):
    """The eval harness and the dataset validator are host Python: the
    port's file is the JAX package's, word for word, with ``v2pe_tpu``
    replaced by ``v2pe_tpu_torch``."""
    import re

    original = (ROOT / "v2pe_tpu" / path).read_text()
    want = re.sub(r"\bv2pe_tpu\b", "v2pe_tpu_torch", original)
    assert (ROOT / "v2pe_tpu_torch" / path).read_text() == want


def test_no_port_source_names_the_jax_package_outside_docstrings():
    """No import, by name or by path, of ``v2pe_tpu`` or ``jax`` in the
    port's sources or in chip_smoke.py."""
    import ast

    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "v2pe_tpu_torch").rglob("*.py"))]
    assert len(files) > 40
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and "\n" not in node.value:
                # a one-line string (a module name handed to importlib, a
                # path): docstrings may name the JAX files they port
                assert "v2pe_tpu." not in node.value.replace(
                    "v2pe_tpu_torch", ""), (path, node.value)
            for n in names:
                assert n.split(".")[0] not in ("v2pe_tpu", "jax"), (path, n)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("preset", ["internvl2_2b", "internvl2_5_8b",
                                    "debug_tiny"])
def test_config_presets_equal_field_for_field(preset):
    want, got = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert type(got) is tconfig.VLMConfig is not jconfig.VLMConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_image_token == want.num_image_token
    assert got.llm.head_dim == want.llm.head_dim
    assert got.llm.num_key_value_groups == want.llm.num_key_value_groups
    assert got.vision.num_patches_per_side == want.vision.num_patches_per_side
    assert got.to_json() == want.to_json()
    assert tconfig.VLMConfig.from_json(want.to_json()) == got
    assert dataclasses.asdict(port_config(want)) == dataclasses.asdict(want)


def test_config_classes_and_mesh_match():
    for name in ("VisionConfig", "LLMConfig", "MeshConfig", "VLMConfig"):
        want, got = getattr(jconfig, name), getattr(tconfig, name)
        assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
            [(f.name, f.type) for f in dataclasses.fields(want)]
    kw = dict(data=2, fsdp=2, seq=2)
    want, got = jconfig.MeshConfig(**kw), tconfig.MeshConfig(**kw)
    assert (got.axis_names, got.shape, got.num_devices) == \
        (want.axis_names, want.shape, want.num_devices)


def test_hf_config_conversion_and_load(tmp_path):
    hf = {"vision_config": {"hidden_size": 64, "num_hidden_layers": 2,
                            "num_attention_heads": 2, "image_size": 56,
                            "intermediate_size": 128, "patch_size": 14},
          "llm_config": {"hidden_size": 96, "num_hidden_layers": 3,
                         "num_attention_heads": 4, "num_key_value_heads": 2,
                         "intermediate_size": 128, "vocab_size": 500,
                         "architectures": ["InternLM2ForCausalLM"]},
          "downsample_ratio": 0.5, "template": "internlm2-chat",
          "max_dynamic_patch": 4}
    assert tconfig.is_hf_config(hf) == jconfig.is_hf_config(hf)
    assert dataclasses.asdict(tconfig.vlm_config_from_hf(hf)) == \
        dataclasses.asdict(jconfig.vlm_config_from_hf(hf))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(hf))
    assert dataclasses.asdict(tconfig.load_vlm_config(str(path))) == \
        dataclasses.asdict(jconfig.load_vlm_config(str(path)))


# -------------------------------------------------------------- positions


def _sequence(rng, tiles, nit, pad):
    ids = []
    for t in tiles:
        ids += list(rng.integers(10, 90, rng.integers(1, 9)))
        ids += [100] + [102] * (t * nit) + [101]
    ids += list(rng.integers(10, 90, 7)) + [0] * pad
    ids = np.asarray(ids)
    return ids, (np.arange(len(ids)) < len(ids) - pad).astype(np.int64)


@pytest.mark.parametrize("version,stride", [
    ("v2pe_fix", 1), ("v2pe_fix", 64), ("v2pe_fix", 256), ("v2pe_rnd", None),
    ("default", None)])
@pytest.mark.parametrize("tiles", [[], [1], [3, 1, 2]])
def test_build_v2pe_pos_ids_equal(version, stride, tiles):
    ids, mask = _sequence(np.random.default_rng(len(tiles)), tiles, 16, 5)
    kw = dict(img_start_id=100, img_end_id=101, num_image_token=16,
              version=version, stride=stride)
    want = jpos.build_v2pe_pos_ids(ids, mask, tiles, rng=random.Random(3),
                                   **kw)
    got = tpos.build_v2pe_pos_ids(ids, mask, tiles, rng=random.Random(3),
                                  **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tpos.V2PE_RND_STRIDES == jpos.V2PE_RND_STRIDES
    np.testing.assert_array_equal(tpos.v2pe.advance_pos_id(7.25, 5),
                                  jpos.v2pe.advance_pos_id(7.25, 5))


# ------------------------------------------------- templates and prompts


TEMPLATES = ["internlm2-chat", "Hermes-2", "phi3-chat", "vicuna_v1.1",
             "internvl2_5"]


def test_constants_equal():
    for name in dir(jconstants):
        if name.isupper():
            assert getattr(tconstants, name) == getattr(jconstants, name), name


@pytest.mark.parametrize("name", TEMPLATES)
def test_conversation_templates_equal(name):
    assert sorted(tconv._REGISTRY) == sorted(jconv._REGISTRY) \
        == sorted(TEMPLATES)
    want, got = jconv.get_conv_template(name), tconv.get_conv_template(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for conv in (want, got):
        conv.append_message(conv.roles[0], "<image>\nWhat is this?")
        conv.append_message(conv.roles[1], "A cat.")
        conv.append_message(conv.roles[0], "And now?")
        conv.append_message(conv.roles[1], None)
    assert got.get_prompt() == want.get_prompt()


@pytest.mark.parametrize("name", TEMPLATES)
def test_preprocess_functions_equal(name):
    tok = _toy_tokenizer()
    sources = [[{"from": "human", "value": "<image>\nDescribe the image."},
                {"from": "gpt", "value": "A picture of a dog."},
                {"from": "human", "value": "What colour?"},
                {"from": "gpt", "value": "Brown."}]]
    kw = dict(num_image_token_list=[8], ds_name="toy", num_image=1)
    try:
        want = jpre.get_preprocess_function(name)(name, sources, tok, **kw)
    except Exception as e:  # a template the toy tokenizer cannot serve
        with pytest.raises(type(e)):
            tpre.get_preprocess_function(name)(name, sources, tok, **kw)
        return
    got = tpre.get_preprocess_function(name)(name, sources, tok, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


# ------------------------------------------------------ tiles, transforms


def _image(seed, h, w):
    from PIL import Image

    return Image.fromarray(np.random.RandomState(seed).randint(
        0, 255, (h, w, 3), dtype=np.uint8))


@pytest.mark.parametrize("h,w,max_num,thumb", [
    (100, 160, 6, True), (600, 1000, 12, True), (448, 448, 6, True),
    (37, 530, 4, False), (900, 300, 12, False)])
def test_dynamic_preprocess_tilings_equal(h, w, max_num, thumb):
    kw = dict(max_num=max_num, image_size=112, use_thumbnail=thumb)
    assert ttiling.plan_tiles(w, h, **kw) == jtiling.plan_tiles(w, h, **kw)
    assert ttiling.candidate_ratios(1, max_num) == \
        jtiling.candidate_ratios(1, max_num)
    img = _image(h + w, h, w)
    want = jtiling.dynamic_preprocess(img, **kw)
    got = ttiling.dynamic_preprocess(img, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for train in (False, True):
        for pad in (False, True):
            random.seed(5)
            a = ttransforms.build_transform(train, 112, pad2square=pad)(img)
            random.seed(5)
            b = jtransforms.build_transform(train, 112, pad2square=pad)(img)
            np.testing.assert_array_equal(a, b)


def test_native_tile_path_matches_pil_and_the_jax_package():
    """Where a C++ compiler is at hand, the port's native library builds
    into its own directory under ``build/`` (a temporary name per process,
    then an atomic rename) and equals the PIL pipeline."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    assert str(ROOT / "build") in tnative._build()
    assert not list(pathlib.Path(tnative._cache_dir()).glob("*.tmp"))
    arr = np.random.RandomState(0).randint(0, 255, (300, 500, 3),
                                           dtype=np.uint8)
    from PIL import Image

    gw, gh, n, _ = ttiling.plan_tiles(500, 300, max_num=6, image_size=112,
                                      use_thumbnail=True)
    tiles = ttiling.dynamic_preprocess(Image.fromarray(arr), max_num=6,
                                       image_size=112, use_thumbnail=True)
    t = ttransforms.build_transform(is_train=False, input_size=112)
    ref = np.stack([t(x) for x in tiles])
    got = tnative.tile_resize_normalize(arr, gw, gh, 112, True,
                                        tconstants.IMAGENET_MEAN,
                                        tconstants.IMAGENET_STD)
    assert got.shape == ref.shape == (n, 3, 112, 112)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(
        tnative.pil_resize_rgb(arr, 112, 224),
        np.asarray(Image.fromarray(arr).resize((224, 112), Image.BICUBIC)))


def test_native_build_survives_a_race(tmp_path, monkeypatch):
    """Four processes that build at once into one empty directory all end
    with the library (the JAX package's loader lets them collide on one
    temporary file)."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    code = ("from v2pe_tpu_torch import native; import sys; "
            "sys.exit(0 if native.available() else 1)")
    env = {**__import__("os").environ, "V2PE_NATIVE_CACHE": str(tmp_path)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                              env=env) for _ in range(4)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0, 0, 0]
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]


# ----------------------------------------------------- datasets, packing


@pytest.fixture(scope="module")
def toy_meta(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    rng = np.random.RandomState(0)
    ann = root / "train.jsonl"
    with open(ann, "w") as f:
        for i in range(12):
            if i % 3 == 2:
                item = {"id": i, "conversations": [
                    {"from": "human", "value": f"What is {i} plus {i}?"},
                    {"from": "gpt", "value": f"The answer is {2 * i}."}]}
            else:
                w, h = rng.choice([100, 300, 500]), rng.choice([100, 200])
                path = f"images/{i}.png"
                _image(i, h, w).save(root / path)
                item = {"id": i, "image": path, "conversations": [
                    {"from": "human", "value": "<image>\nDescribe."},
                    {"from": "gpt", "value": f"A picture number {i}."}]}
            f.write(json.dumps(item) + "\n")
    meta = {"toy": {"root": str(root) + "/", "annotation": str(ann),
                    "repeat_time": 1, "data_augment": False}}
    (root / "meta.json").write_text(json.dumps(meta))
    return str(root / "meta.json")


def _same_tree(got, want, where=""):
    assert type(got) is type(want), where
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_tree(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _same_tree(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


def test_datasets_packing_and_collate_equal(toy_meta):
    """build_datasets items, PackedSampleIterator rows (and its resumable
    state) and collate_rows batches, module against module."""
    tok = _toy_tokenizer()
    kw = dict(image_size=56, num_image_token=4, max_dynamic_patch=6,
              rope_pos_id_stride=2)
    want_ds = jdatasets.build_datasets(toy_meta, tok, **kw)
    got_ds = tdatasets.build_datasets(toy_meta, tok, **kw)
    assert sorted(got_ds) == sorted(want_ds) == ["toy"]
    assert len(got_ds["toy"]) == len(want_ds["toy"]) == 12
    # the native tiler and the PIL route differ by one fp32 ulp in some
    # pixels; the JAX package takes PIL when its native build lost a race
    # with another process, so the port takes the route the JAX twin took
    got_ds["toy"]._native_ok = want_ds["toy"]._native_ok
    for i in (0, 1, 2, 7):
        _same_tree(got_ds["toy"][i], want_ds["toy"][i], f"item {i}")
    ctx = tok.convert_tokens_to_ids("<IMG_CONTEXT>")
    pk = dict(max_tokens=256, max_tiles_per_row=8, seed=1,
              img_context_token_id=ctx)
    want_it = jpacking.PackedSampleIterator(want_ds, **pk)
    got_it = tpacking.PackedSampleIterator(got_ds, **pk)
    wi, gi = iter(want_it), iter(got_it)
    want_rows = [next(wi) for _ in range(3)]
    got_rows = [next(gi) for _ in range(3)]
    _same_tree(got_rows, want_rows, "rows")
    _same_tree(got_it.state_dict(), want_it.state_dict(), "state")
    ck = dict(max_tokens=256, max_tiles=16, img_context_token_id=ctx,
              num_image_token=4)
    _same_tree(tpacking.collate_rows(got_rows[:2], **ck),
               jpacking.collate_rows(want_rows[:2], **ck), "batch")
    for n in (1, 100, 5000):
        for red in ("token", "sample", "square"):
            assert tpacking.len2weight(n, red) == jpacking.len2weight(n, red)
    np.testing.assert_array_equal(tpacking.zigzag_permutation(64, 4),
                                  jpacking.zigzag_permutation(64, 4))


@pytest.mark.parametrize("kw", [
    dict(batch=1, seq_len=1024, tiles_per_row=2, stride=64),
    dict(batch=2, seq_len=384, tiles_per_row=1, stride=2, seed=3),
    dict(batch=1, seq_len=1024, tiles_per_row=2, seq_shards=4)])
def test_make_synthetic_batch_equal(kw):
    want = jsynth.make_synthetic_batch(jconfig.debug_tiny(), **kw)
    got = tsynth.make_synthetic_batch(tconfig.debug_tiny(), **kw)
    _same_tree(got, want)
    assert (tsynth.IMG_START_ID, tsynth.IMG_END_ID, tsynth.IMG_CONTEXT_ID) \
        == (jsynth.IMG_START_ID, jsynth.IMG_END_ID, jsynth.IMG_CONTEXT_ID)


def test_object_store_openers(tmp_path):
    blob = tmp_path / "a.bin"
    blob.write_bytes(b"abc")
    assert tstore.fetch_bytes(str(blob)) == b"abc"
    assert not tstore.is_remote(str(blob)) and tstore.is_remote("gs://b/k")
    tstore.register_opener("toy", lambda url: url.encode())
    assert tstore.open_blob("toy://x").read() == b"toy://x"


# ------------------------------------------------------------ mm_niah_long


@pytest.mark.parametrize("seq_shards,pad_multiple,S",
                         [(1, 256, 300), (4, 64, 300), (2, 100, 257),
                          (8, 256, 1000)])
def test_teacher_forced_inputs_and_predictions_equal(seq_shards,
                                                     pad_multiple, S):
    """``build_teacher_forced_inputs`` (padding, zigzag permutation and its
    inverse) and ``extract_answer_prediction`` of the port's copy against
    the JAX package's: every array equal."""
    rng = np.random.default_rng(S + seq_shards)
    ids = rng.integers(5, 280, S).astype(np.int64)
    pos = np.cumsum(rng.choice([0.25, 1.0], S)).astype(np.float32)
    span = (S - 10, S)
    kw = dict(seq_shards=seq_shards, pad_multiple=pad_multiple)
    want = jniah.build_teacher_forced_inputs(ids, span, pos, **kw)
    got = tniah.build_teacher_forced_inputs(ids, span, pos, **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    logits = rng.standard_normal(
        (1, want["input_ids"].shape[1], 40)).astype(np.float32)
    np.testing.assert_array_equal(
        tniah.extract_answer_prediction(logits, got),
        jniah.extract_answer_prediction(logits, want))


def test_chip_ablate_imports_only_the_port_and_its_edits_apply(tmp_path,
                                                               monkeypatch):
    """chip_ablate.py, which times variants of the flash backward's source
    on the card, imports as chip_smoke.py does (nothing of jax or the JAX
    package), and every edit it names applies to the sources as they are."""
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_IMPORT, "chip_ablate"],
        capture_output=True, text=True, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    sys.path.insert(0, str(ROOT))
    try:
        import chip_ablate
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(chip_ablate, "OUT", str(tmp_path))
    for name, edits in chip_ablate.VARIANTS.items():
        d = pathlib.Path(chip_ablate.write_variant(name))
        for where, _, new in edits:
            assert new in (d / where).read_text(), (name, where)


def test_chip_ablate_quantized_edits_apply(tmp_path, monkeypatch):
    """Every named edit of chip_ablate.py's qmm family (variants of
    quantized_matmul.cu) applies to the source as it is, and its variant
    directory holds every file the source includes."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_ablate
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(chip_ablate, "OUT", str(tmp_path))
    for name, (edits, _) in chip_ablate.QMM_VARIANTS.items():
        d = pathlib.Path(chip_ablate.write_variant(name, "qmm"))
        assert sorted(f.name for f in d.iterdir()) == sorted(
            chip_ablate.FAMILY_FILES["qmm"]), name
        for where, _, new in edits:
            assert new in (d / where).read_text(), (name, where)


def test_chip_ablate_paged_edits_apply(tmp_path, monkeypatch):
    """Every named edit of chip_ablate.py's paged family (variants of
    paged_attention.cu) applies to the source as it is, its variant
    directory holds every file the source includes, and each split rule
    gives a split count between 1 and the page-table width."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_ablate
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(chip_ablate, "OUT", str(tmp_path))
    for name, (edits, rule) in chip_ablate.PAGED_VARIANTS.items():
        d = pathlib.Path(chip_ablate.write_variant(name, "paged"))
        assert sorted(f.name for f in d.iterdir()) == sorted(
            chip_ablate.FAMILY_FILES["paged"]), name
        for where, old, new in edits:
            assert new in (d / where).read_text(), (name, where)
            assert old not in (d / where).read_text(), (name, where)
        if rule is not None:
            for splits in (33, 4, 1):
                assert rule(splits) >= 1, (name, splits)
