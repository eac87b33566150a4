"""A cell's configuration and traffic cut to a size the CPU runs in seconds,
with every width, layer count and batch limit made small and the frame kinds
kept (a merged kind merges at every layer)."""
import copy

from harness import spec

TINY = dict(img_res=32, patch=8, num_tokens=17, num_hidden_layers=4, hidden_size=64,
            num_attention_heads=2, head_dim=32, intermediate_size=128, num_classes=10)
MERGED = ([3, 2, 1, 1], [2, 2, 1, 1], [1, 1, 1, 1])


def tiny(cell: str, dtype: str = "float32", bench: dict | None = None):
    bench = bench or spec.load_benchmark()
    w = spec.workload(bench, cell)
    cfg = dict(spec.config(bench, w["config"]), **TINY, dtype=dtype)
    tr = copy.deepcopy(spec.traffic(w["traffic"]))
    merged = [k for k in tr["mix"] if any(k["schedule"])]
    for i, kind in enumerate(merged):
        kind["schedule"] = MERGED[i % len(MERGED)]
    for kind in tr["mix"]:
        if not any(kind["schedule"]):
            kind["schedule"] = [0, 0, 0, 0]
    tr.update(max_batch=16, streams=min(tr["streams"], 32), image_pool=64,
              warmup_batches=[4], trace_seconds=0.3)
    tr["check"].update(frames=100000, block=64)
    return bench, cfg, tr
