"""The one generator makes every request from the mix and the seed: the
same seed the same text, another seed other records of the same sizes."""

import numpy as np

from benchmark import registry
from benchmark.generate import make_request, reverse_translate

from .conftest import BENCH, TRAFFIC


def full_mix(name):
    return registry.cell({"proteome": "bact1m-proteome",
                          "reads": "bact100k-reads"}[name]).mix


def test_repeats_by_seed(tiny_db):
    for name in ("proteome", "reads"):
        mix = full_mix(name)
        a = make_request(mix, tiny_db, 2**31 + 5, 1, 3)
        b = make_request(mix, tiny_db, 2**31 + 5, 1, 3)
        c = make_request(mix, tiny_db, 2**31 + 6, 1, 3)
        d = make_request(mix, tiny_db, 2**31 + 5, 0, 3)
        assert a == b
        assert a.text != c.text and a.text != d.text
        assert len(a.seqs) == len(c.seqs) == mix["records"]["count"]


def test_proteome_records(tiny_db):
    mix = full_mix("proteome")
    req = make_request(mix, tiny_db, 11, 0, 0)
    db_seqs = {tiny_db.protein(r).tobytes().decode()
               for r in range(tiny_db.n_proteins)}
    lengths = set(tiny_db.lengths.tolist())
    assert len(req.seqs) == 4300
    assert all(len(s) in lengths for s in req.seqs)
    # 70% are database proteins with at most 11 point mutations: most of
    # those keep a whole run of 7-mers, and some are unmutated
    exact = sum(s in db_seqs for s in req.seqs)
    assert 0.03 * 4300 < exact < 0.7 * 4300
    assert req.text.count(">") == 4300
    assert max(len(req.seqs[i]) for i in req.sample) == max(map(len, req.seqs))
    assert len(req.sample) == mix["judge"]["sample_per_request"] + 1 or \
        len(req.sample) == mix["judge"]["sample_per_request"]


def test_reads_records(tiny_db):
    mix = full_mix("reads")
    req = make_request(mix, tiny_db, 12, 1, 2)
    assert len(req.seqs) == 20000
    assert {len(s) for s in req.seqs} == {156}
    assert set("".join(req.seqs)) <= set("acgt")
    flanked = sum(s.startswith("taa") and s.endswith("taa") for s in req.seqs)
    # half come from proteins (flanks kept unless a substitution hit one)
    assert 0.45 * 20000 < flanked < 0.56 * 20000
    lines = req.text.splitlines()
    assert len(lines) == 4 * 20000 and lines[0].startswith("@c1.r2.q0")


def test_reverse_translation_is_table_11():
    from benchmark.reference.orf import CODE11

    prot = "ACDEFGHIKLMNPQRSTVWY"
    dna = reverse_translate(np.frombuffer(prot.encode(), np.uint8)
                            ).tobytes().decode()
    assert "".join(CODE11[dna[i:i + 3]][0]
                   for i in range(0, len(dna), 3)) == prot


def test_tiny_mixes_resolve():
    for w in ("tiny-proteome", "tiny-reads"):
        assert registry.cell(w, BENCH, TRAFFIC).config["proteins"] == 3000


def test_database_lengths_follow_the_configuration(tmp_path):
    """The generator repeats by seed and draws lengths at the
    configuration's median, whatever the database's size."""
    import json
    import os

    from benchmark.database import parse_fasta
    from benchmark.generators import skewed_domains

    with open(os.path.join(os.path.dirname(BENCH), "configs",
                           "tiny.json")) as f:
        config = dict(json.load(f), proteins=20000)
    paths = [str(tmp_path / f"{i}.fa") for i in range(2)]
    for p in paths:
        skewed_domains.write(p, config)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    _, offsets, ids = parse_fasta(paths[0])
    lengths = np.diff(offsets)
    assert ids[0] == "S0000000" and lengths.shape[0] == 20000
    p = config["lengths"]
    assert lengths.min() >= p["min_aa"]
    assert abs(np.median(lengths) / p["median_aa"] - 1) < 0.03
    assert 0.005 < (lengths > 1000).mean() < 0.03
