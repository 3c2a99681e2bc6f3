"""CUDA-graph nodes replayed a training step, mean over the window's steps:
the program's graph_nodes counter, which each replay adds its graph's node
count to (benchmark/recorded.py)."""

from benchmark import recorded


def read(ctx):
    return recorded.graph_nodes_per_step(ctx)
