"""cg_iterations.*: mean CG iterations per load case of the window, from
the program's own count (SolidReactionAnalysis.case_solve_info)."""

from harness import readers


def read(run, reg, name):
    its = [a.info["iterations"] for a in readers.window_answers(run) if "iterations" in a.info]
    if run.mix["kind"] != "cases" or not its:
        return None
    return sum(its) / len(its)
