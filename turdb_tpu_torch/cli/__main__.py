from turdb_tpu_torch.cli.repl import main

if __name__ == "__main__":
    raise SystemExit(main())
