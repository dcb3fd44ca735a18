"""Parallelism of the port across processes: ``dp`` (data parallelism, one
process per card). Model parallelism (tensor, sequence, pipeline, FSDP and
expert parallelism) is ROADMAP A9c."""
