"""graph_solves_per_call: the linear solves the port's pose-graph solvers
launched (their own counter, ``models/pose_graph.SOLVES``) per traced
call; nothing where the program has no such counter."""


def read(run):
    n = (run["launches"] or {}).get("graph_solves")
    return n / run["calls"] if n else None
