"""Tiny overrides of the two cells for CPU runs of the harness."""

TAG = {"config": {"model": {"img_size": 56, "embed_dim": 64, "depth": 2, "num_heads": 1,
                            "mlp_hidden_dim": 112, "num_classes": 64},
                  "labels": {"rating": 4, "general": 48, "character": 12},
                  "serve": {"batch_size": 8}},
       "traffic": {"images_per_pass": 32, "pool_images": 16, "warmup_images": 8,
                   "sample_per_batch": 2, "decode_workers": 2}}
CFEAT = {"config": {"model": {"img_size": 64, "depths": [1, 1, 2, 1], "dims": [16, 32, 64, 64],
                              "num_heads": [0, 0, 2, 2], "feature_dim": 32, "head_hidden": None},
                    "serve": {"batch_size": 4}},
         "traffic": {"pool_batches": 3, "sample": 8}}
