"""The headline lazy MVM of the PyTorch / CUDA port on the card: the twin
of `bench.py` (MaternP(2), d = 3, n = 16384, float32). Prints one JSON
line; see `cfjax_torch/benchmarks/headline.py`.

    python3 bench_torch.py [--n N] [--device cpu]
"""

from cfjax_torch.benchmarks import headline

if __name__ == "__main__":
    headline.main()
