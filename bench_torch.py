"""The PyTorch port's headline bench (the counterpart of bench.py):
batched hybrid retrieval QPS of one CUDA card against the CPU baseline.
Prints one JSON record last on stdout; see legal_rag_tpu_torch/bench.py.

Run from the repository root:  python3 bench_torch.py [--store DIR]
"""

import sys

from legal_rag_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
