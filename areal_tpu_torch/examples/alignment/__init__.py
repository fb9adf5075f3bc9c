"""The alignment entry: reward-model training (``hhrlhf_rw``)."""
