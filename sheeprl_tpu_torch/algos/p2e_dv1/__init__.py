"""Plan2Explore over DreamerV1: exploration and finetuning."""
