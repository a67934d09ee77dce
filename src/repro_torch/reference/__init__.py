"""Plain float32 PyTorch forms of models the port serves beyond the
reference package, written from their published descriptions and the
served weight tree's conventions.  Each file stands alone: it imports
neither JAX nor any module of the port, so the tests hold the port to
something it did not compute."""
