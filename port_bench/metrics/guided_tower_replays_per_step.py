"""CUDA graph replays of the CLIP towers' chunks per step of the traced
guided cycles: the program's `guided.tower.replay` spans over the traced
steps.  Each tower's chunks of a step replay their graphs, so this reads
the chunks a step times the towers where every chunk replays (12 in the
default request's cycle: 15 chunks a tower over 5 steps, 4 towers), fewer
where a key runs eagerly, and 0 where every tower runs eagerly."""

from port_bench import spans


def read(outcome):
    steps = outcome.facts.get("steps_traced", 0)
    if steps <= 0 or not spans.count(outcome, "guided.step"):
        return None
    return spans.count(outcome, "guided.tower.replay") / steps
