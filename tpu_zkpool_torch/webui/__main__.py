from tpu_zkpool_torch.webui.server import main

main()
