"""Faults planted under a run (run.main's `plant`), each of which the
judge has to catch: the engine's answers altered where they are produced,
and half of every batch left out."""


def _wrap_collect(engine, change):
    collect = engine.collect_batch

    def collect_batch(sched, min_top=0):
        return change(collect(sched, min_top))

    engine.collect_batch = collect_batch


def alter_answers(engine):
    """Every query's best count one higher than the engine found."""
    def change(results):
        for qc in results:
            if qc is not None and qc.counts.size:
                qc.counts = qc.counts.copy()
                qc.counts[0] += 1
        return results
    _wrap_collect(engine, change)


def drop_half(engine):
    """Every second query of a batch answered with nothing."""
    def change(results):
        return [None if i % 2 else qc for i, qc in enumerate(results)]
    _wrap_collect(engine, change)
