"""Child process for ``test_torch_observability_server.py``'s SIGTERM test:
one tiny port inference server (no JAX), started from the main thread so
``ServerThread`` arms the flight ring's SIGTERM dump. Prints ``READY
<address> armed|unarmed`` and serves until it is killed; the dump goes to
``$AREAL_FLIGHT_DIR``."""

import time


def main() -> None:
    import torch

    from areal_tpu_torch.api.config import ServerConfig
    from areal_tpu_torch.inference.decode_engine import DecodeEngine
    from areal_tpu_torch.inference.server import ServerThread
    from areal_tpu_torch.models import qwen

    mcfg = qwen.ModelConfig(vocab_size=64, hidden_size=16, intermediate_size=32, num_layers=1, num_heads=2,
                            num_kv_heads=1, dtype="float32")
    model = qwen.init_params(mcfg, torch.Generator().manual_seed(0), device="cpu")
    cfg = ServerConfig(max_batch_size=2, max_seq_len=128, page_size=16, decode_steps_per_call=4, host="127.0.0.1")
    st = ServerThread(cfg, DecodeEngine(cfg, params=model, device="cpu"))
    st.start()
    print(f"READY {st.address} {'armed' if st.signal_dump_armed else 'unarmed'}", flush=True)
    while True:
        time.sleep(1.0)


if __name__ == "__main__":
    main()
