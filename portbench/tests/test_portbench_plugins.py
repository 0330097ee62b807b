"""A configuration, a traffic mix and a per-layer metric each come in as
new files alone: a throwaway one of each, added to a copy, runs."""

import json
import os

from conftest import make_tree, rehearse


def test_new_config_traffic_and_metric_as_files_alone(tmp_path):
    tree = make_tree(str(tmp_path))
    pb = os.path.join(tree, "portbench")
    with open(os.path.join(pb, "configs", "tiny_0002.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_0001"
    cfg["product"] = dict(cfg["product"], nfft=8, nint=16)
    with open(os.path.join(pb, "configs", "tiny_0001.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    traffic.update(name="tiny_paced", bank_gbps=0.5)
    with open(os.path.join(pb, "traffic", "tiny_paced.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pb, "metrics", "bank.rows.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.banks))\n")
    with open(os.path.join(tree, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_0001",
                             "file": "portbench/configs/tiny_0001.json"})
    bench["workloads"].append({"name": "tiny_0001.paced", "config": "tiny_0001",
                               "traffic": "tiny_paced", "chips": 1})
    bench["per_layer"].append({"name": "bank.rows", "unit": "count",
                               "workloads": ["tiny_0001.paced"]})
    with open(os.path.join(tree, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, last, err = rehearse(tree, "tiny_0001.paced", trace=True)
    assert rc == 0, err
    assert last["correct"] is True, err
    assert last["metrics"]["bank.rows"]["value"] == 2.0
