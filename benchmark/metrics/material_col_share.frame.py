"""material_col_share.frame: of the material-table entries a whole-table
gather would write in the traced window (the program's counter
`bsdf.cols.packed`, N_MAT_COLS x lanes of each `material_params`), the share
the gather wrote (`bsdf.cols.gathered`, the rows the scene's BSDF kinds read
x lanes). None where the program has no such counters or gathered nothing."""

from benchmark import program_spans as ps


def read(run):
    c = ps.counts()
    if c is None or not c.get("bsdf.cols.packed"):
        return None
    return c.get("bsdf.cols.gathered", 0) / c["bsdf.cols.packed"]
