"""Chunks the Monte-Carlo driver ran by replaying its captured CUDA graph,
per chunk of the profiled stretch (counter ``mc.graph_replays``): 1 where
every chunk replays, 0 where ``run_monte_carlo`` runs its chunks eagerly
(relay, a mesh, the CPU); None where nothing counts it (the quality mode, a
program without the graph path)."""

from pb_spans import counter_per_chunk


def read(summary: dict) -> float | None:
    return counter_per_chunk(summary, "mc.graph_replays")
