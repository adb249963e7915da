"""Mean recall@10 of every answer of a one-query window against the
reference's exact top 10 (judges/search.py): the same number as
``recall_at_10``, under a bound of its own, since the window's thousand
queries are a sample that the seed draws."""


def read(run):
    return run.judged.get("recall")
