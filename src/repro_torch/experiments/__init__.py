"""The paper's PTQ experiments on the port: weights (Tables 1, 2, 5, 6, 7)
and activations (Tables 3, 4).

``python -m repro_torch.experiments.run [--quick] [--only table2,table6]
[--device cpu]`` trains the three subjects (``common``) on first use and
prints each table with its claim checks. The reference's files are
``benchmarks/table*.py``; each ``tableN.run(quick, bench)`` here computes
the same rows and columns on the port's own trained subjects.
"""
