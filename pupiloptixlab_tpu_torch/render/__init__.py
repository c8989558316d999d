"""Device-side rendering: sampling, BSDFs, emitters, textures, integrator."""
