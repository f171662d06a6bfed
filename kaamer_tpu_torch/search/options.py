"""Search options, mirroring reference search.SearchOptions (search.go:56-71)
with the server's defaults (api/server.go:139-207)."""

from __future__ import annotations

from dataclasses import dataclass

NUCLEOTIDE = 0
PROTEIN = 1
READS = 2

DNA_QUERY = "DNA Query"
PROTEIN_QUERY = "Protein Query"


@dataclass
class SearchOptions:
    File: str = ""
    InputType: str = ""
    SequenceType: int = PROTEIN
    GeneticCode: int = 11
    OutFormat: str = "tsv"
    MaxResults: int = 10
    Align: bool = False
    ExtractPositions: bool = False
    Annotations: bool = False
    SubMatrix: str = "blosum62"
    GapOpen: int = 11
    GapExtend: int = 1
    MinKMatch: int = 10
    MinKRatio: float = 0.05
