"""What the metric readers share: the answers of the window itself
(without the requests a traced run sends under the profiler afterwards),
and the benchmark's own spans, kept per run (Run.span) and read as means."""


def window_answers(run):
    return run.answers[:len(run.answers) - run.profiled_requests]


def completed(run) -> int:
    """Requests of the window answered to the configured accuracy, by the
    program's own report of its residual."""
    return sum(1 for a in window_answers(run) if a.info.get("converged"))


def mean_span(run, name: str):
    v = run.spans.get(name)
    return sum(v) / len(v) if v else None
