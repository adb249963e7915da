"""Share of the traced window's part A in which no kernel, copy or fill
ran on the device (torch.profiler, CUDA activity, stage timers off): part
A's busy seconds over the seconds that the same requests took again with
the profiler off (part U)."""

from h100_bench.metrics._read import idle_pct


def read(run):
    return idle_pct(run)
