"""Host ms a traced job inside `sampler.colour_plan` spans (the program's
call records): `ColoredGibbs.init` building its colour plan, with the plan's
waits for the device. A program without the span reads None."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")
    calls = program.traced_calls(run)
    if not calls or not all(any(s["name"] == "sampler.colour_plan" for s in c["spans"])
                            for c in calls):
        return None
    return program.per_job(run, lambda c: program.span_ms(c, "sampler.colour_plan"))
