"""Linear-probe scaling-sweep drivers (reference CLIP_benchmark/probe_benchmark).

Thin runners over :func:`bcosification_tpu_torch.clip_benchmark.cli.run` that reproduce the
reference's LAION scaling experiments — a grid of (model, dataset,
fewshot_k, lr, epochs) linear probes — plus the pandas post-processing
that assembles the sweep outputs into the scaling-law dataframes/tables
(ref `CLIP_benchmark/probe_benchmark/{scaling_experiments,
laion5b_fewshot_experiments,build_df_scaling_experiments,generate_table,
process_vtab}.py`).

The sweep grids are the reference's verbatim; dataset/model availability is
whatever the port's `clip_benchmark.datasets.builder` + checkpoint store can
serve (hosts without network access run them against wds/* mirrors or `dummy`).
"""
