"""BERT fine-tuning trainer: the port of mec_tpu/training/train_text_bert.py.

Parity with reference model_training/train_text_model.py: AdamW 2e-5
weight decay 0.01 with a 10% linear warmup then linear decay to 0 over
the optimizer updates, grad clip 1.0, batch 16, 5 epochs, 85/15
stratified split, the best-val-accuracy weights saved in servable form
(bert_model.mecp with meta val_acc, config.json, vocab.txt; the JAX
trainer's files).

The corpus is sliced to the smallest Config.SEQ_BUCKETS length that
covers its longest text, but never below 32 (the JAX trainer's floor):
exact either way, since padded keys get attention weight 0 and pooling
reads [CLS]. --grad-accum K averages K micro-batch gradients into one
update (optax.MultiSteps' semantics), --remat recomputes each encoder
layer in the backward pass, --bf16 runs the fp32 model under
torch.autocast(bfloat16) (the parameters stay fp32). --pretrained-dir:
a bert_model.mecp there initialises the encoder (all but the
classifier), else its HF weights (pytorch_model.bin or
model.safetensors, converted by convert/hf_bert.py, as the JAX trainer
converts them; a failed conversion raises); a directory holding only
vocab.txt gives the vocab and a random init, as in JAX.

--experts N swaps every layer's FFN for N top-1-routed experts
(models/moe.py); the loss is the cross-entropy plus 0.01 times the sum
of the layers' load-balancing losses, and config.json gets num_experts
and moe_capacity_factor. A dense pretrained encoder cannot initialise an
MoE one: the JAX trainer copies its dense layers over the MoE layers and
then fails at the first step for want of the expert bank (ROADMAP queue
C), so this one raises up front. --experts with --mesh-pipe exits as in
JAX.

--mesh-data D, --mesh-model M and --mesh-pipe P train over the D*M*P
ranks of an initialized process group (parallel/mesh.py, rank = (d*M +
m)*P + p as JAX's make_mesh lays devices out; python -m mec_tpu_torch
starts them), as the JAX trainer does (its train_text_bert.py:112-127,
174-180, 217-245): each data rank on its rows of every global batch;
with M > 1 Megatron tensor parallelism of the encoder
(parallel/partition.shard_bert), and with --experts the expert bank
split over the model axis (expert parallelism); --seq-parallel shards
the residual stream's sequence over it too (needs M > 1 and no pipe, and
a padded length that divides by M); with P > 1 a GPipe pipeline of the
encoder layers over --microbatches microbatches
(parallel/pipeline.py, every layer recomputed in the backward pass as
JAX's pipeline does). The artifacts are the whole model's Flax tree
(partition.gather_bert), written by rank 0.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mec_tpu_torch.config import Config
from mec_tpu_torch.convert import store
from mec_tpu_torch.convert.from_jax import state_from_jax
from mec_tpu_torch.convert.to_jax import to_jax
from mec_tpu_torch.models.bert import BertForSequenceClassification
from mec_tpu_torch.parallel.partition import gather_bert, shard_bert
from mec_tpu_torch.parallel.pipeline import make_pipeline_steps, split_stages
from mec_tpu_torch.text.wordpiece import WordPieceTokenizer
from mec_tpu_torch.training import common, data, metrics

# the Flax model's defaults, and the config.json keys the JAX trainer
# writes for them
WIDTHS = {'vocab_size': ('vocab_size', 30522),
          'hidden_size': ('hidden_size', 768),
          'num_layers': ('num_hidden_layers', 12),
          'num_heads': ('num_attention_heads', 12),
          'intermediate_size': ('intermediate_size', 3072),
          'max_position': ('max_position_embeddings', 512),
          'type_vocab_size': ('type_vocab_size', 2),
          'num_classes': ('num_labels', 7)}


def make_steps(model: BertForSequenceClassification, bf16: bool = False,
               moe_aux_weight: float = 0.01):
    dev_type = next(model.parameters()).device.type

    def forward(batch, aux=False):
        with torch.autocast(dev_type, torch.bfloat16, enabled=bf16):
            return model(batch['ids'], batch['mask'], return_aux=aux)

    def train_step(state: common.TrainState, batch):
        logits, _cls, aux = forward(batch, aux=True)
        onehot = F.one_hot(batch['label'].long(), logits.shape[-1])
        loss = common.softmax_cross_entropy(logits, onehot)
        if aux:
            # the MoE layers' load-balancing losses (models/moe.py)
            loss = loss + moe_aux_weight * sum(aux)
        loss.backward()
        state.apply_gradients()
        return loss

    def eval_step(state: common.TrainState, batch):
        return forward(batch)[0]

    return train_step, eval_step


def tokenize_corpus(tokenizer: WordPieceTokenizer, texts,
                    max_length: int = 128):
    ids, mask = tokenizer.encode_batch(list(texts), max_length=max_length)
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


def init_from_pretrained(model: BertForSequenceClassification,
                         bert_dir: str, log=print) -> None:
    """Load the encoder (every top-level node but the classifier) from
    bert_dir/bert_model.mecp, or else from the HF weights there
    (pytorch_model.bin or model.safetensors, converted as the JAX trainer
    converts them, mec_tpu/training/train_text_bert.py:86-97); random
    init when the directory holds neither. A failed conversion raises,
    where the JAX trainer falls back to random init (C5). Its layers must
    have the model's FFN kind (dense or MoE)."""
    if not bert_dir or not os.path.isdir(bert_dir):
        return
    nat = os.path.join(bert_dir, 'bert_model.mecp')
    if os.path.exists(nat):
        source, pre = nat, store.load_params(nat)['variables']['params']
    elif any(os.path.exists(os.path.join(bert_dir, f)) for f in
             ('pytorch_model.bin', 'model.safetensors')):
        from mec_tpu_torch.convert.hf_bert import convert_bert_dir
        source, pre = bert_dir, convert_bert_dir(bert_dir)['params']
    else:
        log(f'Pretrained init unavailable (no bert_model.mecp, '
            f'pytorch_model.bin or model.safetensors in {bert_dir}); '
            f'using random init')
        return
    variables = to_jax(model)
    for k, v in variables['params'].items():
        if k.startswith('layer_') and k in pre \
                and ('moe' in v) != ('moe' in pre[k]):
            raise ValueError(
                f'{source}: its {k} is '
                f'{"an MoE" if "moe" in pre[k] else "a dense"} layer and the '
                f'model\'s is {"an MoE" if "moe" in v else "a dense"} one '
                f'(--experts {model.num_experts}): a pretrained encoder '
                f'initialises only a model with the same FFN (the JAX '
                f'trainer copies the dense layers over the MoE ones and '
                f'then fails for want of the expert bank)')
    for k in variables['params']:
        if k in pre and k != 'classifier':
            variables['params'][k] = pre[k]
    model.load_state_dict(state_from_jax(variables))
    log(f'Initialized encoder from {source}')


def train(csv_path: str, epochs: int = 5, batch_size: int = 16,
          learning_rate: float = 2e-5, max_length: int = 128,
          models_dir: Optional[str] = None, pretrained_dir: str = '',
          mesh_data: int = 0, mesh_model: int = 0, seed: int = 42,
          model_kwargs: Optional[dict] = None,
          tokenizer: Optional[WordPieceTokenizer] = None,
          texts=None, labels=None, verbose: bool = True,
          seq_bucket: bool = True, mesh_pipe: int = 0,
          microbatches: int = 2, seq_parallel: bool = False,
          experts: int = 0, grad_accum: int = 1, remat: bool = False,
          bf16: bool = False, device='cuda'):
    """Returns (best variables as a Flax tree, history)."""
    if seq_parallel:
        # the sequence dim shards over the tensor-parallel 'model' axis
        # (JAX train_text_bert.py:112-127)
        if mesh_model <= 1:
            raise SystemExit('--seq-parallel requires --mesh-model > 1 '
                             '(the sequence dim shards over the tensor-'
                             'parallel axis)')
        if mesh_pipe > 1:
            raise SystemExit('--seq-parallel with --mesh-pipe is not '
                             'supported (the pipeline stages own the model '
                             'axis)')
    if experts > 0 and mesh_pipe > 1:
        raise SystemExit('--experts with --mesh-pipe is not supported '
                         '(the pipeline stage apply is dense-FFN only)')
    mesh = common.train_mesh(mesh_data, mesh_model, mesh_pipe)
    dev = common.resolve_device(device)
    log = common.logger(verbose, mesh)
    if texts is None:
        texts, labels = data.load_text_dataset(csv_path, fold_labels=False,
                                               verbose=verbose)
    if len(texts) == 0:
        raise SystemExit('No training data found')

    if tokenizer is None:
        vocab_src = pretrained_dir or Config.BERT_MODEL_PATH
        tokenizer = WordPieceTokenizer.from_pretrained_dir(vocab_src)
        if tokenizer is None:
            raise SystemExit(f'No vocab.txt under {vocab_src}; pass '
                             '--pretrained-dir with a BERT vocab')

    tr, va = metrics.train_test_split_stratified(len(texts), labels,
                                                 0.15, seed=42)
    ids, mask = tokenize_corpus(tokenizer, texts, max_length)
    if seq_bucket:
        # the smallest bucket covering the longest text, floor 32: the
        # dropped columns are padding for every row (attention weight 0,
        # [CLS] pooling), so loss and gradients are unchanged
        longest = int(mask.sum(axis=1).max()) if mask.size else 1
        for s in sorted(set(Config.SEQ_BUCKETS)):
            if longest <= s < max_length and s >= 32:
                ids, mask = ids[:, :s], mask[:, :s]
                log(f'corpus max {longest} tokens; padded length {s} '
                    f'(exact w.r.t. the attention mask)')
                break
    if seq_parallel and ids.shape[1] % mesh_model:
        raise ValueError(f'--seq-parallel: the padded length {ids.shape[1]} '
                         f'does not split over --mesh-model {mesh_model}')
    train_data = {'ids': ids[tr], 'mask': mask[tr],
                  'label': np.asarray(labels)[tr]}
    val_data = {'ids': ids[va], 'mask': mask[va],
                'label': np.asarray(labels)[va]}
    log(f'Training set: {len(tr)}  validation set: {len(va)}')

    model_kwargs = dict(model_kwargs or {})
    if experts > 0:
        model_kwargs.setdefault('num_experts', experts)
    widths = {k: model_kwargs.get(k, d) for k, (_c, d) in WIDTHS.items()}
    model = BertForSequenceClassification(**model_kwargs, remat=remat)
    common.flax_init(model, seed)
    init_from_pretrained(model, pretrained_dir, log)
    if mesh is not None:
        shard_bert(model, mesh, seq_parallel)
        split_stages(model, mesh)
    model.to(dev)
    if remat:
        log('rematerialization: encoder layer activations recomputed in '
            'the backward pass (torch.utils.checkpoint)')

    grad_accum = max(1, int(grad_accum))
    # schedules count OPTIMIZER updates (common.optimizer_total_steps)
    total_steps = common.optimizer_total_steps(len(tr), batch_size,
                                               epochs, grad_accum)
    # 10% linear warmup then linear decay to 0
    warmup_steps = max(1, total_steps // 10)
    lr = common.join_schedules(
        [common.linear_schedule(0.0, learning_rate, warmup_steps),
         common.linear_schedule(learning_rate, 0.0,
                                max(1, total_steps - warmup_steps))],
        [warmup_steps])
    tx = common.adamw_with_clip(lr, weight_decay=0.01, clipnorm=1.0)
    if grad_accum > 1:
        tx = common.multi_steps(tx, grad_accum)
        log(f'gradient accumulation: {grad_accum} micro-batches of '
            f'{batch_size} per optimizer update (effective batch '
            f'{batch_size * grad_accum})')
    state = common.TrainState(model, tx)
    if mesh_pipe > 1:
        train_step, eval_step = make_pipeline_steps(model, mesh,
                                                    microbatches, bf16)
    else:
        train_step, eval_step = make_steps(model, bf16)

    state, best_vars, history = common.fit(
        state, train_data, val_data, train_step, eval_step,
        epochs=epochs, batch_size=batch_size, seed=seed,
        monitor='val_acc', mesh=mesh, log_fn=log)

    model.load_state_dict(best_vars)
    padded, n = common.pad_batch(val_data, len(va))
    with torch.no_grad():
        logits = eval_step(state, common.to_device(padded, dev))
    preds = logits.float().cpu().numpy()[:n].argmax(axis=-1)
    log('\n' + metrics.classification_report(val_data['label'], preds,
                                             Config.EMOTIONS))

    variables = (gather_bert(model) if hasattr(model, 'mec_mesh')
                 else to_jax(model))
    if not common.writes(mesh):
        common.barrier(mesh)
        return variables, history
    common.record_metrics('bert_text', max(history['val_acc']),
                          val_data['label'], preds)
    models_dir = models_dir or Config.BERT_MODEL_PATH
    os.makedirs(models_dir, exist_ok=True)
    store.save_params(os.path.join(models_dir, 'bert_model.mecp'),
                      variables,
                      meta={'val_acc': float(max(history['val_acc']))})
    cfg = {c: int(widths[k]) for k, (c, _d) in WIDTHS.items()}
    if model.num_experts > 0:
        cfg['num_experts'] = model.num_experts
        cfg['moe_capacity_factor'] = model.moe_capacity_factor
    with open(os.path.join(models_dir, 'config.json'), 'w') as f:
        json.dump(cfg, f, indent=2)
    vocab_out = os.path.join(models_dir, 'vocab.txt')
    if not os.path.exists(vocab_out):
        # by id position (line number = token id), so an id gap in the
        # source vocab cannot renumber later tokens
        lines = [''] * (max(tokenizer.vocab.values()) + 1)
        for tok, i in tokenizer.vocab.items():
            lines[i] = tok
        with open(vocab_out, 'w', encoding='utf-8') as f:
            f.write('\n'.join(lines))
    log(f'Saved BERT artifacts to {models_dir}')
    common.barrier(mesh)
    return variables, history


def main(argv=None):
    p = argparse.ArgumentParser(description='Fine-tune BERT for emotion')
    p.add_argument('--csv', required=True)
    p.add_argument('--epochs', type=int, default=5)
    p.add_argument('--batch-size', type=int, default=16)
    p.add_argument('--learning-rate', type=float, default=2e-5)
    p.add_argument('--max-length', type=int, default=128)
    p.add_argument('--models-dir', default=None)
    p.add_argument('--pretrained-dir', default='',
                   help='BERT dir for encoder init (bert_model.mecp) + '
                        'vocab')
    p.add_argument('--mesh-data', type=int, default=0,
                   help='data-parallel axis size (the ranks are data x '
                        'model x pipe, one a GPU)')
    p.add_argument('--mesh-model', type=int, default=0,
                   help='tensor-parallel axis size for the encoder')
    p.add_argument('--mesh-pipe', type=int, default=0,
                   help='pipeline-parallel stages for the encoder '
                        '(GPipe; num_layers must divide evenly; '
                        'composes with --mesh-model into a 3D '
                        'DPxTPxPP mesh)')
    p.add_argument('--microbatches', type=int, default=2,
                   help='pipeline microbatches per step (with '
                        '--mesh-pipe; the rows pad to a multiple)')
    p.add_argument('--grad-accum', type=int, default=1,
                   help='accumulate gradients over K micro-batches '
                        'before each optimizer update (optax.MultiSteps;'
                        ' effective batch = batch-size * K)')
    p.add_argument('--remat', action='store_true',
                   help='recompute encoder-layer activations in the '
                        'backward pass (torch.utils.checkpoint)')
    p.add_argument('--experts', type=int, default=0,
                   help='Mixture-of-Experts FFN: swap every encoder '
                        'layer\'s dense FFN for N top-1-routed experts '
                        '(models/moe.py; with --mesh-model > 1 the '
                        'expert bank shards over the model axis: expert '
                        'parallelism)')
    p.add_argument('--seq-parallel', action='store_true',
                   help='Megatron sequence parallelism: shard the '
                        'residual stream\'s sequence dim over the '
                        'tensor-parallel axis (requires --mesh-model > 1)')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 compute under torch.autocast (params '
                        'stay float32)')
    p.add_argument('--no-seq-bucket', action='store_true',
                   help='pad every text to --max-length like the '
                        'reference instead of the smallest covering '
                        'bucket (bucketing is exact w.r.t. the '
                        'attention mask)')
    common.add_device_flag(p)
    args = p.parse_args(argv)
    train(args.csv, args.epochs, args.batch_size, args.learning_rate,
          args.max_length, args.models_dir, args.pretrained_dir,
          args.mesh_data, args.mesh_model,
          seq_bucket=not args.no_seq_bucket, mesh_pipe=args.mesh_pipe,
          microbatches=args.microbatches, seq_parallel=args.seq_parallel,
          experts=args.experts, grad_accum=args.grad_accum,
          remat=args.remat, bf16=args.bf16, device=args.device)


if __name__ == '__main__':
    main()
