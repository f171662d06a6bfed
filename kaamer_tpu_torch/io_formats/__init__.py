from .readers import (
    open_maybe_gzip,
    parse_fasta,
    parse_tsv,
    parse_embl,
    parse_gbk,
    PARSERS,
    read_fasta_queries,
    read_fastq_queries,
)
