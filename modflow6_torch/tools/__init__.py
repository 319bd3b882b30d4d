"""Studies of the port on its device: time to solution per preconditioner
and precision (``iteration_study``) and the general partition's halo
traffic and sharded cost (``halo_study``)."""
