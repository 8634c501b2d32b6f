from vers_tpu_torch.demo import main

if __name__ == "__main__":
    main()
