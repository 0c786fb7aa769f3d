"""A cell at a size the CPU holds: the real configuration file's shape
with every width and depth cut, and a mix of a few short requests."""

from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*path):
    with open(os.path.join(HERE, *path)) as f:
        return json.load(f)


def tiny_config(name: str = "internvl2-2b", kv_heads: int = 2) -> dict:
    conf = copy.deepcopy(_json("configs", f"{name}.json"))
    m = conf["model"]
    m["vision"].update(hidden_size=32, intermediate_size=64,
                       num_hidden_layers=2, num_attention_heads=2)
    m["llm"].update(hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=kv_heads)
    return conf


def tiny_mix(traffic: str = "mmdoc") -> dict:
    mix = copy.deepcopy(_json("traffic", f"{traffic}.json"))
    mix["engine"].update(max_rows=2, max_len=1024, page_size=16,
                         chunk_size=64, decode_block=4)
    mix["clients"] = 2
    mix["ramp_s"] = 1
    mix["rounds"] = 2
    mix["bank_tiles"] = 4
    mix["document"].update(images=[1, 2], image_side=[448, 900],
                           max_tiles_per_image=2, max_tiles=3,
                           text_tokens=[20, 80])
    mix["question_tokens"] = [4, 8]
    mix["answer_tokens"] = [3, 6]
    mix["check"] = {"served_tokens": 12, "max_requests": 3}
    return mix


def tiny_cell(config: str = "internvl2-2b", traffic: str = "mmdoc",
              kv_heads: int = 2) -> dict:
    return {"name": f"tiny.{traffic}", "chips": 1, "entry": {},
            "config": tiny_config(config, kv_heads),
            "traffic": tiny_mix(traffic), "limits": {}}
