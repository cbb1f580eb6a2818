"""Block matching, depth LM, fusion, regularization and denoising."""
