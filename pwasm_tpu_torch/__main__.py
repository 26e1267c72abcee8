from pwasm_tpu_torch.cli import main

main()
