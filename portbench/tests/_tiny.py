"""A benchmark root of small cells for CPU tests: the real configuration
cut to a few layers and small widths, the real prefill cell's traffic
at small batches and lengths through the port's plain paths, judged by
the real cell's limits; and a small decode cell through the
`serve_batch` entry, which no cell of `BENCHMARK.json` runs yet, with
its own traffic, limit and metrics, as a later change would add them."""
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"

#: tiny prefill cell -> the real cell it stands for.
PREFILL_CELLS = {"tm.prefill": "mixtral-8x22b.prefill-azure"}
CELLS = [*PREFILL_CELLS, "tm.decode"]
TINY = {"mixtral-8x22b-8l": dict(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, head_dim=16, d_ff=128,
                                 vocab_size=512, sliding_window=64,
                                 n_experts=4)}

#: The small cells' traffic: prefill through the plain paths.
PREFILL = dict(impl="chunked", batch=2, lengths=[16, 32, 64],
               trace_batches=3, check={"batches": {"16": 2, "32": 1,
                                                   "64": 1}})
DECODE = dict(entry="serve_batch", impl="naive", batch=4, lengths=[8],
              generated=8, warm_steps=2, trace_batches=1,
              check={"requests": 3})
#: The decode cell's limit: a mean gap of the size sound decode runs of
#: the real configuration stay well under on the card.
DECODE_LIMITS = {"mean_gap": {"limit": 0.12, "lower": 0.048,
                              "upper": 0.27}}
#: End-to-end metrics that BENCHMARK.json reads in every cell and the
#: small decode cell cannot report: this root reads them in the small
#: prefill cells alone.
PREFILL_METRICS = ("prefill_tokens_per_s", "ttft_p95_ms")
DECODE_METRICS = (
    ("decode_tokens_per_s", "end_to_end", "tokens/s", None),
    ("step_mfu.decode", "per_layer", "%", "model step"),
    ("launch_calls_per_step.decode", "per_layer", "calls", "host dispatch"),
    ("idle_share.decode", "per_layer", "%", "device"))


def make_root(tmp: Path, sizes: dict = TINY, prefill: dict = PREFILL,
              decode: dict = DECODE) -> Path:
    """`tmp` as a benchmark root holding the small cells."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "limits"):
        (tmp / "portbench" / kind).mkdir(parents=True, exist_ok=True)
    configs = []
    for c in spec["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        f["model"].update(sizes[c["name"]])
        name = "t" + c["name"][0]
        (tmp / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(f))
        configs.append(dict(c, name=name,
                            file=f"portbench/configs/{name}.json"))
    cells, renamed = [], {}
    for tiny, real in PREFILL_CELLS.items():
        w = next(w for w in spec["workloads"] if w["name"] == real)
        t = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        t.update(prefill)
        (tmp / "portbench" / "traffic" / f"t.{w['traffic']}.json") \
            .write_text(json.dumps(t))
        (tmp / "portbench" / "limits" / f"{tiny}.json").write_text(
            (PB / "limits" / f"{real}.json").read_text())
        cells.append(dict(w, name=tiny, config="t" + w["config"][0],
                          traffic=f"t.{w['traffic']}"))
        renamed[real] = tiny
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renamed[w] for w in m["workloads"]]
        elif m["name"] in PREFILL_METRICS:
            m["workloads"] = list(PREFILL_CELLS)
    (tmp / "portbench" / "traffic" / "t.decode.json").write_text(
        json.dumps(decode))
    (tmp / "portbench" / "limits" / "tm.decode.json").write_text(
        json.dumps(DECODE_LIMITS))
    cells.append({"name": "tm.decode", "config": "tm", "traffic": "t.decode",
                  "chips": 1, "why": "small decode cell"})
    for name, kind, unit, layer in DECODE_METRICS:
        m = {"name": name, "unit": unit, "better": "higher",
             "source": "host_clock" if layer is None else "device_trace",
             "workloads": ["tm.decode"]}
        if layer is None:
            m["bound"] = 0.01
        else:
            m.update(layer=layer, moves="decode_tokens_per_s")
        spec[kind].append(m)
    spec.update(configs=configs, workloads=cells)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
