"""SAC-AE: pixel SAC with an autoencoder."""
