"""Multi-device scaling on torch.distributed: voice, frame and job sharding
over a DeviceMesh (mesh.py), and a launcher that runs a function on several
local ranks (launch.py)."""
