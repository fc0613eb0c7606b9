"""Numeric engines: RNG streams, Sobol QMC, GBM Monte-Carlo (threefry and CUDA kernel engines), FFT spectrum, analytic oracle."""
