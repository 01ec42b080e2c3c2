"""Print the registered solvers of each family, as ``python -m
cfgpp_tpu.solvers`` does (the reference's latent_diffusion.py:1015-1018):

    python -m cfgpp_tpu_torch.solvers
"""

from cfgpp_tpu_torch.solvers.registry import list_solvers

if __name__ == "__main__":
    print(f"Possible SD solvers: {list_solvers('sd')}")
    print(f"Possible SDXL solvers: {list_solvers('sdxl')}")
