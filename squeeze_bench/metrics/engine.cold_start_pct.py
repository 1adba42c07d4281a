"""Share of the window's starts that were cold (a full prefill), of all
starts: cold, warm re-binds and snapshot restores (the engine's counters)."""


def read(run):
    c = {k: sum(d[k] for d in run["counters"]) for k in run["counters"][0]}
    total = c["cold"] + c["warm"] + c["restore"]
    return 100.0 * c["cold"] / total if total else None
