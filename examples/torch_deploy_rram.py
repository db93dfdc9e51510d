"""Deploy a trained LM onto simulated RRAM with HARP write-and-verify,
in the PyTorch port.

The paper's pipeline end to end (`examples/deploy_rram.py` in PyTorch):
train a small LM -> quantize (B=6, Bc=3) -> bit-slice onto signed
column pairs -> program with CW-SC / MRA / HD-PV / HARP under severe
read noise -> serve with the programmed (noisy) weights and compare eval
loss.  This is Fig. 10's experiment on the framework's own workload.
With ``--in-array`` each deployment is also served through the arrays
(`CIMExecutor`: DAC 6 / ADC 10 bits, read noise 0.2 LSB) and that eval
loss printed beside the digital one.

    PYTHONPATH=src python examples/torch_deploy_rram.py --steps 150 --noise 0.7
    PYTHONPATH=src python examples/torch_deploy_rram.py --device cpu --steps 3
"""

import argparse

import torch

from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.core import NoiseConfig, WVConfig, WVMethod, rng
from repro_torch.core.programmer import deploy_arrays
from repro_torch.data import SyntheticLM
from repro_torch.models import ModelConfig
from repro_torch.models.transformer import loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--noise", type=float, default=0.7, help="read noise, LSB")
    ap.add_argument("--n-cells", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--in-array", action="store_true",
                    help="also serve each deployment through the arrays")
    args = ap.parse_args()
    dev = args.device

    cfg = ModelConfig(
        name="deploy-demo", n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
        head_dim=24, d_ff=192, vocab_size=64, dtype=torch.float32,
        attn_chunk_q=32, attn_chunk_kv=32, remat=False,
    )
    data = SyntheticLM(vocab_size=64, seq_len=64, global_batch=16, seed=1, device=dev)
    opt_cfg = AdamWConfig(lr_peak=1e-2)
    state = init_train_state(0, cfg, opt_cfg, device=dev)
    step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    for i in range(args.steps):
        state, _ = step(state, data.global_batch_at(i)._asdict())
    eval_batch = data.global_batch_at(99_999)._asdict()

    def eval_loss(params) -> float:
        with torch.no_grad():
            return float(loss_fn(params, eval_batch, cfg)[0])

    clean = eval_loss(state.params)
    print(f"trained {args.steps} steps on {dev}; clean eval loss = {clean:.4f}\n")

    analog = CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2)
    print(f"{'method':8s} {'eval loss':>10s} {'dloss':>8s} {'rms[LSB]':>9s} "
          f"{'iters':>6s} {'E[uJ]':>8s}" + (f" {'in-array':>9s}" if args.in_array else ""))
    for method in WVMethod:
        wv = WVConfig(
            method=method, n_cells=args.n_cells,
            noise=NoiseConfig(sigma_read_lsb=args.noise),
        )
        deployed, report = deploy_arrays(rng.PRNGKey(7, device=dev), state.params, wv,
                                         device=dev)
        loss = eval_loss(deployed.materialize())
        row = (f"{method.value:8s} {loss:10.4f} {loss - clean:+8.4f} "
               f"{report.rms_cell_error_lsb:9.3f} {report.mean_iterations:6.1f} "
               f"{report.total_energy_pj / 1e6:8.2f}")
        if args.in_array:
            ex = CIMExecutor(deployed, analog, rng.PRNGKey(9, device=dev))
            row += f" {eval_loss(ex.params()):9.4f}"
        print(row)
    print("\nUnder severe read noise the Hadamard-domain methods (hd_pv,")
    print("harp) should preserve eval loss where cw_sc degrades.")


if __name__ == "__main__":
    main()
