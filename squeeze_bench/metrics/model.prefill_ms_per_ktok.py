"""Cold-start prefill wall (the engine's ``prefill`` StepEvents, each
ending in a device synchronise) per thousand prompt tokens."""
from squeeze_bench.metrics._common import events, prompt_of


def read(run):
    evs = events(run, "prefill")
    if not evs:
        return None
    prompt = prompt_of(run)
    ktok = sum(prompt[e.detail["rid"]] for e in evs) / 1e3
    return 1e3 * sum(e.wall_s for e in evs) / ktok
