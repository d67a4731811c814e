"""The caching allocator's device segments allocated plus freed a traced
job (`cudaMalloc` and `cudaFree` calls): its call record's change of
`segment.all.allocated` and `segment.all.freed`, kept on a CUDA device."""
from bench.common import load_module


def read(run):
    program = load_module("metrics", "_program", run.root / "bench")

    def segments(record):
        counts = record["counts"]
        keys = ("cuda.segment.all.allocated", "cuda.segment.all.freed")
        return sum(counts[k] for k in keys) if all(k in counts for k in keys) else None

    return program.per_job(run, segments)
