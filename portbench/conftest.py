"""Small sizes for the benchmark's tests of the configurations that are
not genomes.

``portbench/tests/conftest.py``'s ``small_spec`` cuts the configurations
of ``BENCHMARK.json`` by name, and names only the genome ones.  This
session fixture builds ``small_spec`` with the configurations of
``SMALL`` set aside, then adds each of them at its own small size, so
every cell of ``BENCHMARK.json`` runs at a small size through
``small_spec`` and ``run_small``.
"""

from __future__ import annotations

import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# configuration -> (text bytes, mem, warm-up text bytes): 60,000 bytes in
# 3 blocks of the merge engine
SMALL = {"pizzachili-proteins-bounded": (60000, 16 * 20224, 6000)}


def small_text_config(name: str, text_bytes: int, mem=None) -> dict:
    """The configuration ``name`` of ``BENCHMARK.json`` at ``text_bytes``
    bytes of text (and ``mem``, where given)."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        c = json.load(f)
    c["text"]["text_bytes"] = text_bytes
    if mem:
        c["options"]["mem"] = mem
    return c


@pytest.fixture(scope="session", autouse=True)
def _small_spec_of_every_configuration(request, tmp_path_factory):
    from portbench import harness
    load = harness.load_spec

    def without_small(root: str = harness.ROOT) -> dict:
        spec = load(root)
        spec["configs"] = [c for c in spec["configs"]
                           if c["name"] not in SMALL]
        return spec

    harness.load_spec = without_small
    try:
        spec = request.getfixturevalue("small_spec")
    finally:
        harness.load_spec = load
    d = tmp_path_factory.mktemp("spec_text")
    for c in load()["configs"]:
        if c["name"] not in SMALL:
            continue
        text_bytes, mem, warmup = SMALL[c["name"]]
        path = d / (c["name"] + ".json")
        path.write_text(json.dumps(small_text_config(c["name"], text_bytes,
                                                     mem)))
        spec["configs"].append(dict(c, file=str(path)))
        for w in spec["workloads"]:
            if w["config"] != c["name"]:
                continue
            with open(w["traffic"] + ".json") as f:
                traffic = json.load(f)
            traffic["warmup_text_bytes"] = warmup
            with open(w["traffic"] + ".json", "w") as f:
                json.dump(traffic, f)
