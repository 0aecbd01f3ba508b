"""live_lane_share.frame: of the rays the traced window's closest-hit casts
were given (the program's counter `cast.closest.rays`, unpadded), the share
still alive, with maxt >= mint (`cast.closest.live`, counted in the
closest-hit kernel). Every bounce casts every lane of a chunk, alive or
not: this is the casts' useful work over their attempts."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("cast.closest.rays"):
        return None
    return c["cast.closest.live"] / c["cast.closest.rays"]
