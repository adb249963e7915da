"""Mean recall@10 of every answer of the window against the reference's
exact top 10 (judge.py)."""


def read(run):
    return run.judged.get("recall")
