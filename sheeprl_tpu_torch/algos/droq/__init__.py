"""DroQ: SAC with a dropout and LayerNorm critic ensemble."""
