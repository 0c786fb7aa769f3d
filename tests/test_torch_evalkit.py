"""The eval harness of the port (``evalkit/``, ``data/validate.py``) against
the JAX package's: every scoring and parsing function on the same inputs
with equal results, and whole benchmark routes through ``evalkit.cli.main``
of both packages (one checkpoint exported by JAX, a saved toy tokenizer,
made-up items and images) with the same greedy responses and scores; the
port's ``--engine-rows`` equal to its sequential route."""

import base64
import io
import json
import random

import jax
import numpy as np
import pytest

from v2pe_tpu.core.config import LLMConfig, VLMConfig, VisionConfig
from v2pe_tpu.evalkit import cli as jcli
from v2pe_tpu.models.export import export_torch_state_dict as jax_export
from v2pe_tpu.models.export import save_safetensors as jax_save
from v2pe_tpu.models.params import init_vlm_params as jax_init
from v2pe_tpu_torch.evalkit import cli as tcli

from .test_data_pipeline import _toy_tokenizer

# ------------------------------------------------------------------ scoring


class _Pkg:
    """The evalkit modules of one package, by name."""

    def __init__(self, root: str):
        import importlib

        self.root = root
        self._mod = lambda n: importlib.import_module(f"{root}.evalkit.{n}")

    def __getattr__(self, name):
        return self._mod(name)


JAX, PORT = _Pkg("v2pe_tpu"), _Pkg("v2pe_tpu_torch")

VQA_CASES = [("A cat.", "cat"), ("The answer is B.", "b"),
             ("two dogs", "2 dogs"), ("it's a sunny day", "its a sunny day"),
             ("isn't", "isnt"), ("yes, definitely!", ["no", "yes"]),
             ("4", ["four"]), ("completely wrong", "right")]
NIAH_CASES = [(1, "B"), (1, "b."), (0, "The answer is A."), (2, "right"),
              (3, "none"), ([1, 2, 3], "[1, 2, 3]"),
              ([1, 2], "```json\n[1, 2]\n```"), ([1, 2], "nonsense"),
              ("cat", "A cat."), ("42", "The answer is 42.")]
MC_RESPONSES = ["The answer is (B).", "A", " B ",
                "I think the answer could be option (C) or maybe (A)",
                "the correct choice is definitely the red pyramid of giza",
                "B. a dog", "blah", "(A) no wait, (D)", "A B C"]
OPEN_RESPONSES = ["The final answer is 42.",
                  "So the result is 1,234,567 apples", "x = 3.14159",
                  "It is approximately 6.02e23 molecules",
                  "no clear answer here",
                  "The value is -0.5, thus -0.5 is correct"]
OPTIONS = ["a cat", "a dog", "the red pyramid of giza", "42"]
LETTERS = {"A": "a cat", "B": "a dog", "C": "a fish"}
POPE_TEXTS = ["Yes, it is there.", "No, I do not see it.",
              "it is not visible, although maybe", "Yes",
              "The object, clearly, is present. No doubt."] * 3
POPE_LABELS = ["yes", "no", "yes", "no", "yes"] * 3
MMMU_OUTPUTS = [
    {"id": "v1", "category": "Art", "question_type": "multiple-choice",
     "options": ["red", "blue"], "answer": "A",
     "prediction": "The answer is (A)."},
    {"id": "v2", "category": "Art", "question_type": "multiple-choice",
     "options": ["red", "blue"], "answer": "B", "prediction": "it is red"},
    {"id": "v3", "category": "Math", "question_type": "open",
     "options": [], "answer": "42", "prediction": "it equals 42"}]
MMBENCH_ROW = {"index": "7", "question": "What animal?",
               "hint": "Look closely.", "A": "cat", "B": "dog", "C": None,
               "D": None, "E": None, "answer": "B", "image": "",
               "category": "x", "source": "s", "comment": None,
               "l2-category": "y"}


def _niah_file(tmp):
    rng = random.Random(0)
    path = tmp / "model_retrieval-text-test.jsonl"
    with open(path, "w") as f:
        for i in range(60):
            ans = rng.choice(["cat", "dog", "bird"])
            f.write(json.dumps({
                "id": i, "context_length": rng.choice([900, 3000, 30000]),
                "placed_depth": rng.random(), "answer": ans,
                "response": ans if i % 2 else "wrong"}) + "\n")
    return path


def _pope(ek, tmp):
    labels = tmp / "coco_pope_random.json"
    with open(labels, "w") as f:
        for lbl in POPE_LABELS:
            f.write(json.dumps({"label": lbl}) + "\n")
    outputs = [{"question_id": i, "category": "random", "order": i,
                "text": t} for i, t in enumerate(POPE_TEXTS)]
    return (ek.pope.score_category(POPE_TEXTS, POPE_LABELS),
            ek.pope.score_outputs(outputs, {"random": str(labels)}))


def _mmbench(ek, tmp):
    tsv = tmp / "bench.tsv"
    with open(tsv, "w") as f:
        f.write("index\tquestion\tA\tB\thint\tanswer\timage\n")
        f.write("1\tQ?\topt1\topt2\t\tA\tabc\n")
    rows = ek.mmbench.read_tsv(str(tsv))
    outputs = [{"index": "7", "prediction": "B. dog",
                "options": ek.mmbench.extract_options(MMBENCH_ROW),
                "answer": "B"}]
    sub = tmp / "submission.jsonl"
    ek.mmbench.write_submission([MMBENCH_ROW], outputs, str(sub))
    return (rows, ek.mmbench.build_question(MMBENCH_ROW, "en"),
            ek.mmbench.build_question(MMBENCH_ROW, "cn"),
            ek.mmbench.score_outputs(outputs), sub.read_text())


def _mmmu_mc(ek):
    index2ans, choices = ek.mmmu.get_multi_choice_info(OPTIONS)
    out = []
    for resp in MC_RESPONSES:
        rng = random.Random(1234)
        out.append(ek.mmmu.parse_multi_choice_response(
            resp, choices, index2ans, rng=rng))
    return index2ans, choices, out


def _mmmu_eval(ek):
    samples = [
        {"id": "s1", "question_type": "multiple-choice", "answer": "B",
         "parsed_pred": "B"},
        {"id": "s2", "question_type": "multiple-choice", "answer": "A",
         "parsed_pred": "C"},
        {"id": "s3", "question_type": "open", "answer": "42",
         "parsed_pred": ek.mmmu.parse_open_response("it is 42")}]
    results = {"Art": {"acc": 0.5, "num_example": 10},
               "Math": {"acc": 0.25, "num_example": 30}}
    opens = [ek.mmmu.eval_open(g, ek.mmmu.parse_open_response(r))
             for g, r in [("42", "the answer is 42"),
                          (["3.14", "pi"], "so it is pi"),
                          ("7", "I do not know")]]
    return (opens, ek.mmmu.evaluate_samples(samples),
            ek.mmmu.calculate_ins_level_acc(results))


def _milebench(ek):
    mc = [ek.milebench.judge_multi_choice(gt, pred, choices)
          for pred, choices, gt in [
              ("B. a dog", ["a cat", "a dog", "a fish"], "a dog"),
              ("The answer is a cat", ["a cat", "a dog"], "a cat"),
              ("C", ["one", "two", "three"], "three"),
              ("nonsense", ["one", "two"], "one")]]
    preds = [{"sample_id": 0, "gt_response": "needle", "image": ["a"] * 2,
              "pred_response": "the needle is here"},
             {"sample_id": 1, "gt_response": "pin", "image": ["a"] * 40,
              "pred_response": "no idea"}]
    return (mc, [ek.milebench.process(s) for s in
                 ["A. cat!", "it's 1,000 (approx)", "  Hello\nWorld  "]],
            ek.milebench.evaluate_needle(preds),
            [ek.milebench.rouge_l_f(a, b) for a, b in
             [("a b c", "a b c"), ("x y z", "a b c"), ("a b d", "a b c")]])


def _longvqa(ek):
    entries = [{"answer": "102", "annotation": ["100"]},
               {"answer": "0.5", "annotation": "50%"},
               {"answer": "cat", "annotation": "dog"}]
    return ([ek.longvqa.decide_metric(t) for t in
             ["chartqa", "svqa", "deepform", "docvqa", "textvqa",
              "textcaps", "wikitablequestions", "unknown_task"]],
            ek.longvqa.score_groups({"32": entries, "64": entries[:1]},
                                    "chartqa"),
            [ek.longvqa.score_entry(m, p, g) for m, p, g in
             [("ANLS", "hello", ["hello"]), ("F1", "a b", "a c"),
              ("BLEU4", "a b c d e", "a b c d e"),
              ("TEXTVQA", "cat", ["cat"] * 10)]])


def _judge(ek):
    """Only the judge's parsing and bookkeeping: no service is called."""
    preds = [{"video_id": "v", "question_raw": "q?", "answer": "a",
              "outputs": "a"},
             {"video_id": "v", "question_raw": "r?", "answer": "b",
              "outputs": "c"}]
    parsed = [ek.gpt_judge.parse_judge_response(r) for r in
              ["{'pred': 'yes', 'score': 4}", "{'pred': 'no', 'score': 1}"]]
    try:
        ek.gpt_judge.parse_judge_response("{'score': 2}")
    except ValueError as e:
        bad = str(e)
    combined = {"v_0": [parsed[0], {}], "v_1": [parsed[1], {}]}
    return (parsed, bad, ek.gpt_judge.build_prediction_set(preds),
            ek.gpt_judge.build_judge_messages("q?", "a", "b"),
            ek.gpt_judge.summarize(combined))


def _validate():
    """``data/validate.py`` on a good and a broken sample."""
    import importlib

    out = []
    for root in ("v2pe_tpu", "v2pe_tpu_torch"):
        v = importlib.import_module(f"{root}.data.validate")
        ids = [1, 5, 7, 7, 6, 2, 5, 7, 6]
        out.append([v.validate_sample(
            {"input_ids": ids[:n], "num_tiles": [1] * (n // 4),
             "image_flags": [1], "pos_ids": np.arange(n, dtype=np.float32),
             "labels": [-100] * (n - 1) + [2]}, num_image_token=2,
            img_start_id=5, img_end_id=6, img_context_id=7) for n in (5, 8)])
    return out


SCORING = {
    "metrics.VQAEval": lambda ek, tmp: [
        ek.metrics.VQAEval().evaluate(a, g) for a, g in VQA_CASES],
    "metrics.mmniah_is_correct": lambda ek, tmp: [
        ek.metrics.mmniah_is_correct(a, r) for a, r in NIAH_CASES],
    "metrics.anls": lambda ek, tmp: [
        ek.metrics.anls(p, a) for p, a in
        [("hello world", ["hello world"]), ("helo world", ["hello world"]),
         ("zzz", ["hello world"]), ("", [""]), ("abcd", ["abzz"])]],
    "metrics.relaxed_accuracy": lambda ek, tmp: [
        ek.metrics.relaxed_accuracy(p, g) for p, g in
        [("102", "100"), ("110", "100"), ("50%", "0.5"), ("cat", "CAT")]],
    "metrics.exact_match_mc": lambda ek, tmp: [
        ek.metrics.exact_match_mc("B", "B"),
        ek.metrics.exact_match_mc("B.", "B"),
        ek.metrics.exact_match_mc("The cat", "A",
                                  options=["the cat", "a dog"]),
        ek.metrics.exact_match_mc("D", "B")],
    "mm_niah.score_jsonl": lambda ek, tmp: ek.mm_niah.score_jsonl(
        str(_niah_file(tmp))),
    "mm_niah.score_directory": lambda ek, tmp: (
        _niah_file(tmp), ek.mm_niah.score_directory(str(tmp)))[1],
    "mmmu.parse_multi_choice_response": lambda ek, tmp: _mmmu_mc(ek),
    "mmmu.parse_open_response": lambda ek, tmp: [
        sorted(map(str, ek.mmmu.parse_open_response(r)))
        for r in OPEN_RESPONSES],
    "mmmu.eval_open_and_aggregation": lambda ek, tmp: _mmmu_eval(ek),
    "mmmu.post_process_option_letter": lambda ek, tmp: [
        ek.mmmu.post_process_option_letter(p, LETTERS) for p in
        ["B", "B. a dog", "a dog", "The image shows a dog", "Z strange",
         "C.", ""]],
    "mmmu.score_outputs": lambda ek, tmp: ek.mmmu.score_outputs(
        MMMU_OUTPUTS, rng=random.Random(0)),
    "mmmu.build_question": lambda ek, tmp: [
        ek.mmmu.build_question("What is shown?", ["a cat", "a dog"]),
        ek.mmmu.build_question("Count the objects.", [], "open")],
    "pope.score": _pope,
    "mmbench.tsv_prompt_score_submission": _mmbench,
    "scienceqa.prompt_and_score": lambda ek, tmp: (
        ek.scienceqa.build_question("Which is heavier?",
                                    ["feather", "brick"], hint="Think."),
        ek.scienceqa.gold_letter(1),
        ek.scienceqa.score_outputs(
            [{"prediction": "B. brick", "options": {"A": "feather",
                                                    "B": "brick"},
              "answer": "B"},
             {"prediction": "feather", "options": {"A": "feather",
                                                   "B": "brick"},
              "answer": "B"}])),
    "seed.score_outputs": lambda ek, tmp: ek.seed.score_outputs(
        [{"prediction": "A", "answer": "A", "question_type_id": 1},
         {"prediction": "B. wrong", "answer": "A", "question_type_id": 1},
         {"prediction": "C", "answer": "C", "question_type_id": 2},
         {"prediction": "D", "answer": "A", "question_type_id": 10}],
        {1: "Scene Understanding", 2: "Instance Identity",
         10: "Action Recognition"}),
    "milebench": lambda ek, tmp: _milebench(ek),
    "longvqa": lambda ek, tmp: _longvqa(ek),
    "vqa_driver.score_outputs": lambda ek, tmp: [
        ek.vqa_driver.score_outputs(ds, outs) for ds, outs in
        [("chartqa_test_human",
          [{"question_id": 1, "answer": "102", "annotation": "100"},
           {"question_id": 2, "answer": "7", "annotation": "9"}]),
         ("docvqa_val", [{"questionId": 1, "answer": "hello",
                          "annotation": ["hello"]}])]],
    "video.score": lambda ek, tmp: (
        ek.video.score([{"response": "A", "answer": "A"},
                        {"response": "(B) dog", "answer": "C"},
                        {"response": "x", "answer": None}]),
        ek.video.score_buckets(
            [{"correct": True, "duration": "short", "task": ["a", "b"]},
             {"correct": False, "duration": "long", "task": ["a"]},
             {"correct": None, "duration": "long"}], ["duration", "task"]),
        [ek.video.extract_answer_letter(r) for r in
         ["(A) cat", "Answer: B", "the answer is c", "none"]],
        [ek.video.judge_mc_video(r, a) for r, a in
         [("(A) cat", "A"), ("B.", "C")]]),
    "vqa.score_suite": lambda ek, tmp: ek.vqa.score_suite(
        {"chartqa": [{"prediction": "102", "annotation": "100"}],
         "textvqa": [{"prediction": "cat", "annotation": ["cat"] * 10}],
         "pope": [{"prediction": "Yes it is", "annotation": "yes"}]}),
    "gpt_judge.parse": lambda ek, tmp: _judge(ek),
}


def test_validate_sample_equals_jax():
    want, got = _validate()
    assert got == want and want[0] != want[1]


@pytest.mark.parametrize("name", sorted(SCORING))
def test_scoring_equals_jax(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = SCORING[name](JAX, tmp_path / "j")
    got = SCORING[name](PORT, tmp_path / "t")
    assert json.dumps(got, default=repr, sort_keys=True) == \
        json.dumps(want, default=repr, sort_keys=True)


# --------------------------------------------------- routes through the CLI


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """A checkpoint of a small random model exported by the JAX package in
    float32, the toy tokenizer saved beside it, and an image."""
    from PIL import Image

    from v2pe_tpu.data.constants import SPECIAL_TOKENS

    root = tmp_path_factory.mktemp("bench")
    tok = _toy_tokenizer()
    tok.save_pretrained(str(root / "tok"))
    tok.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)
    cfg = VLMConfig(
        vision=VisionConfig(hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=2,
                            image_size=56, patch_size=14),
        llm=LLMConfig(vocab_size=len(tok), hidden_size=64,
                      intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2),
        rope_pos_id_stride=2)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    tree = jax_init(jax.random.PRNGKey(7), cfg)
    jax_save(jax_export(tree, cfg), str(ckpt / "model.safetensors"),
             dtype="float32")
    (ckpt / "config.json").write_text(cfg.to_json())
    Image.fromarray(np.random.RandomState(0).randint(
        0, 255, (64, 80, 3), dtype=np.uint8)).save(root / "x.png")
    return root


def _jsonl(path, items):
    with open(path, "w") as f:
        for it in items:
            f.write(json.dumps(it) + "\n")
    return str(path)


def _items(bench, route):
    img = str(bench / "x.png")
    if route == "mm_niah":
        return "retrieval", _jsonl(bench / "niah.jsonl", [
            {"id": 0, "context": "The cat is orange. " * 6,
             "question": "What is the cat?", "answer": "orange",
             "images_list": [], "meta": {"context_length": 1200,
                                         "placed_depth": 0.5}},
            {"id": 1, "context": "<image>\nA cat sitting on a mat. ",
             "question": "Where is the cat?", "answer": "mat",
             "images_list": ["x.png"], "meta": {"context_length": 900,
                                                "placed_depth": [0.1]}}])
    if route == "mmmu":
        return "test", _jsonl(bench / "mmmu.jsonl", [
            {"id": "a1", "category": "Art", "question_type":
             "multiple-choice", "question": "What is shown?",
             "options": ["cat", "dog"], "answer": "A", "image": img},
            {"id": "a2", "category": "Art", "question_type": "open",
             "question": "How many?", "options": [], "answer": "2",
             "image": img}])
    if route == "pope":
        return "test", _jsonl(bench / "pope.jsonl", [
            {"question_id": i, "category": "random", "order": i,
             "image": img, "text": q} for i, q in
            enumerate(["Is there a cat?", "Is there a mat?",
                       "Is there a dog?"])])
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.RandomState(1).randint(
        0, 255, (64, 64, 3), dtype=np.uint8)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    path = bench / "bench.tsv"
    with open(path, "w") as f:
        f.write("index\tquestion\tA\tB\thint\tanswer\timage\n")
        f.write(f"1\tWhat animal?\tcat\tdog\t\tA\t{b64}\n")
        f.write(f"2\tWhat color?\torange\tblue\tLook.\tB\t{b64}\n")
    return "test", str(path)


def _argv(bench, route, out, *extra):
    task, data = _items(bench, route)
    argv = ["--benchmark", route, "--checkpoint", str(bench / "ckpt"),
            "--tokenizer", str(bench / "tok"), "--data", data,
            "--outputs-dir", str(out), "--task", task, "--max-num", "2",
            "--max-new-tokens", "6", *extra]
    if route == "pope":
        labels = bench / "labels"
        labels.mkdir(exist_ok=True)
        _jsonl(labels / "coco_pope_random.json",
               [{"label": x} for x in ("yes", "yes", "no")])
        argv += ["--pope-label-dir", str(labels)]
    return argv


def _outputs(out):
    """Every merged output file's records, by file name, and the scores the
    CLI printed."""
    files = {p.name: [json.loads(l) for l in open(p)]
             for p in sorted(out.glob("*.jsonl")) if ".rank" not in p.name}
    return files


def _run_jax(bench, route, out, monkeypatch, capsys, *extra):
    import functools

    from v2pe_tpu.infer import chat as jchat_mod

    monkeypatch.setenv("V2PE_COMPILE_CACHE", "0")
    monkeypatch.setattr(jchat_mod, "ChatModel", functools.partial(
        jchat_mod.ChatModel, attn_impl="jnp"))
    capsys.readouterr()
    random.seed(0)  # MMMU's scorer guesses from the global generator
    jcli.main(_argv(bench, route, out, *extra))
    return json.loads(capsys.readouterr().out)


def _run_port(bench, route, out, capsys, *extra, tokenizer=None):
    capsys.readouterr()
    random.seed(0)
    tcli.main(_argv(bench, route, out, "--platform", "cpu", *extra),
              tokenizer=tokenizer)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("route", ["mm_niah", "mmmu", "pope", "mmbench"])
def test_cli_route_equals_jax(route, bench, tmp_path, monkeypatch, capsys):
    """The same greedy responses, token for token, and the same scores;
    then ``--score-only`` on both outputs."""
    want = _run_jax(bench, route, tmp_path / "j", monkeypatch, capsys)
    got = _run_port(bench, route, tmp_path / "t", capsys)
    assert _outputs(tmp_path / "t") == _outputs(tmp_path / "j")
    assert got == want
    n = sum(len(v) for k, v in _outputs(tmp_path / "t").items()
            if "submission" not in k)
    assert n == {"mm_niah": 2, "mmmu": 2, "pope": 3, "mmbench": 2}[route]
    if route == "mmbench":
        assert (tmp_path / "t" / "mmbench_submission.jsonl").read_text() == \
            (tmp_path / "j" / "mmbench_submission.jsonl").read_text()
    want = _run_jax(bench, route, tmp_path / "j", monkeypatch, capsys,
                    "--score-only")
    got = _run_port(bench, route, tmp_path / "t", capsys, "--score-only")
    assert got == want


@pytest.mark.parametrize("route", ["pope", "mm_niah"])
def test_cli_engine_rows_equal_the_sequential_route(route, bench, tmp_path,
                                                    capsys):
    """``--engine-rows 2``: the items go through ``EngineChat`` from two
    threads; records and scores equal the sequential route's, and the
    engine's scheduler is stopped when ``main`` returns."""
    import threading

    seq = _run_port(bench, route, tmp_path / "seq", capsys)
    threads = set(threading.enumerate())
    eng = _run_port(bench, route, tmp_path / "eng", capsys,
                    "--engine-rows", "2", "--engine-max-len", "1024")
    key = "question_id" if route == "pope" else "id"
    by_id = lambda out: {name: {r[key]: r for r in recs}
                         for name, recs in _outputs(out).items()}
    assert by_id(tmp_path / "eng") == by_id(tmp_path / "seq")
    assert eng == seq
    assert set(threading.enumerate()) <= threads
    with pytest.raises(SystemExit, match="num-beams"):
        _run_port(bench, route, tmp_path / "beam", capsys,
                  "--engine-rows", "2", "--num-beams", "2")


def test_cli_takes_a_tokenizer_object_and_a_trainer_checkpoint(
        bench, tmp_path, capsys):
    """``main(argv, tokenizer=...)`` answers as ``--tokenizer`` does, and a
    step directory of the port's trainer (``params.pt``) answers as the
    safetensors checkpoint it was saved from."""
    from transformers import AutoTokenizer

    from v2pe_tpu_torch.core import checkpoint as ckpt
    from v2pe_tpu_torch.core.config import load_vlm_config
    from v2pe_tpu_torch.data.constants import SPECIAL_TOKENS
    from v2pe_tpu_torch.models.params import load_safetensors_checkpoint

    want = _run_port(bench, "pope", tmp_path / "a", capsys)
    tok = AutoTokenizer.from_pretrained(str(bench / "tok"))
    tok.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)
    got = _run_port(bench, "pope", tmp_path / "b", capsys, tokenizer=tok)
    assert got == want
    assert _outputs(tmp_path / "b") == _outputs(tmp_path / "a")
    cfg = load_vlm_config(str(bench / "ckpt" / "config.json"))
    model = load_safetensors_checkpoint(str(bench / "ckpt"), cfg,
                                        __import__("torch").bfloat16, "cpu")
    step = ckpt.save_checkpoint(str(tmp_path / "run"), 1, model, {}, cfg=cfg)
    argv = _argv(bench, "pope", tmp_path / "c", "--platform", "cpu")
    argv[argv.index("--checkpoint") + 1] = step
    capsys.readouterr()
    random.seed(0)
    tcli.main(argv)
    assert json.loads(capsys.readouterr().out) == want
    assert _outputs(tmp_path / "c") == _outputs(tmp_path / "a")


def test_cli_without_platform_needs_a_cuda_device(bench, tmp_path,
                                                  monkeypatch):
    """With no ``--platform`` the model goes to the CUDA card: where there is
    none the CLI raises, naming ``--platform cpu``, and writes no output."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tcli.main(_argv(bench, "pope", tmp_path / "o"))
    assert not list((tmp_path / "o").glob("*.jsonl"))
    assert tcli.build_argparser().parse_args(
        ["--benchmark", "pope", "--checkpoint", "c", "--tokenizer", "t",
         "--data", "d", "--outputs-dir", "o"]).platform == "cuda"
