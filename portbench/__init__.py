"""The port's benchmark: cells of `BENCHMARK.json` run on one NVIDIA card
(`python3 -m portbench.run`), judged by the plain reference in
`portbench/reference/`."""
