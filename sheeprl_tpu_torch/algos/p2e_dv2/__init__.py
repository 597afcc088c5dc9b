"""Plan2Explore over DreamerV2: exploration and finetuning."""
