"""placement_share_max: the busiest replica's share of the window's
placements (``ServingFleet.stats``): 1/replicas when DDS spreads evenly."""


def read(run):
    total = sum(run.placements.values())
    if run.kind != "serve" or total <= 0:
        return None
    return max(run.placements.values()) / total
