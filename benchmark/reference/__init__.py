"""Plain references, one module a kind of scene, found by the name that a
configuration file gives under ``reference`` (``reference/<name>.py``).

A reference module imports neither the program under test nor the JAX
package, and works everything out from the configuration file.  It holds:

- ``rest_positions(scene) -> [N, 3]`` float64: the rest shape, in the
  program's vertex order; rounded to float32 it is every episode's start
  position, handed to both sides;
- ``start_velocity(config, generator, device) -> [N, 3]`` float32: an
  episode's start velocity, drawn from ``generator`` (a CPU
  ``torch.Generator`` seeded for the episode);
- ``Reference(config, dtype, device)``, with ``frame(x, v) -> (x, v)``,
  one frame from ``[N, 3]`` positions and velocities, and ``normals(x) ->
  [N, 3]``, the unit vertex normals (used where the configuration's limits
  judge ``n_err``).
"""
