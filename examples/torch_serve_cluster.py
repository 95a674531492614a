"""Serve a small model with batched requests on a real-compute cluster,
with the PyTorch port.

The reference's ``examples/serve_cluster.py`` through ``repro_torch``:
the LP plans the mixed/solo split, the occupancy gate admits prefills,
chunked prefill runs fused with decodes (the paper's mixed iteration) as
actual compute -- decode attention through the B1 kernel on the card --
and completed prefills migrate their KV to solo servers.  The flags are
:mod:`repro_torch.launch.serve`'s: the reference's, with ``--device``
(the CUDA card by default; ``cpu`` runs the kernels' plain versions).

Run:  PYTHONPATH=src python examples/torch_serve_cluster.py [--servers 4]
      PYTHONPATH=src python examples/torch_serve_cluster.py --device cpu
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:])
