"""The benchmark of the PyTorch/CUDA port (``anime_illust_image_searcher_tpu_torch``).

Run a cell from the root of a checkout::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See README.md in this folder for how cells, configurations, traffic mixes,
metrics and kernel groups are found by name.
"""
