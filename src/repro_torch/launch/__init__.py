# Launchers: device meshes and the process group, sharding assignments,
# the training launcher.  Import modules directly (repro_torch.launch.mesh,
# repro_torch.launch.train, ...).
