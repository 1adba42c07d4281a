"""The expert path's time against its bound: over the ``decode.moe`` spans
in the traced window, the least bytes each step's expert blocks must move
(``moe_costs.expert_path_bytes``, from the experts each step hit) at the
HBM rate, over the blocks' device time (``expert_ms``)."""
from squeeze_bench import costs, moe_costs
from squeeze_bench.metrics._spans import in_window


def read(run):
    steps = [r.attrs for r, _a, _b in in_window(run, "decode.moe")
             if "expert_ms" in r.attrs]
    ms = sum(a["expert_ms"] for a in steps)
    if not ms:
        return None
    nbytes = sum(moe_costs.expert_path_bytes(
        run["model"], a["experts_hit"], a["layers"], a["tokens"])
        for a in steps)
    return 100.0 * nbytes / costs.HBM_BW / (ms / 1e3)
