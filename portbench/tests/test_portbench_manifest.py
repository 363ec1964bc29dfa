"""BENCHMARK.json and the files it names: the contract's name and unit
characters, every per-layer metric's `moves` reported by every cell that
reports the metric, a file for every configuration, traffic mix, metric
and cell limit, configurations that are the templates' values."""

import json
import re

from portbench.harness.common import HERE, ROOT, Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_files():
    m = Manifest()
    d = m.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    names = [x["name"] for x in d["configs"] + d["workloads"]
             + d["end_to_end"] + d["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for x in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert set(m.limits(w["name"]))
    for x in d["per_layer"]:
        assert (HERE / "metrics" / f"{x['name']}.py").exists()
    assert len(json.dumps(d)) <= 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    m = Manifest()
    for w in m.data["workloads"]:
        e2e = {x["name"] for x in m.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = m.per_layer(w["name"])
        assert layers
        for x in layers:
            assert x["moves"] in e2e, (w["name"], x["name"])


def test_configs_are_the_templates():
    from speinet_tpu_torch.config import Config, set_template

    for name, template in (("speinet", "SPEINet"), ("swint", "SWINT")):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        t = set_template(Config(template=template))
        keys = ("model", "n_sequence", "n_feat", "n_resblock", "embed_dim", "depths",
                "num_heads", "window_size", "mlp_ratio", "patch_size", "batch_size",
                "loss", "lr", "drop_path_rate", "size_must_mode")
        assert {k: cfg[k] for k in keys} == {k: getattr(t, k) for k in keys}
        assert cfg["reduced"] == []
