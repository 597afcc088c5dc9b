"""Plan2Explore over DreamerV3: exploration and finetuning."""
