"""StateCell / TrainingDecoder / BeamSearchDecoder, after
paddle_tpu/fluid/contrib/decoder/beam_search_decoder.py (reference
python/paddle/fluid/contrib/decoder/beam_search_decoder.py).

The user contract of the reference: a StateCell whose `state_updater`
defines one decode step, a TrainingDecoder that trains it over ragged
targets (a DynamicRNN whose memories are the cell's states), and a
BeamSearchDecoder whose `decode()` builds beam-search generation sharing
the cell.  Generation is the JAX package's dense unrolled search: every
source keeps exactly `beam_size` rows, the beam_search op returns parent
pointers, and the states reorder with one `gather` a step, as
models/machine_translation.py generates.  `block()` is the reference's
build-your-own-step form: a While owned by the decoder, threading tensor
arrays through its trips.
"""

import contextlib

from ...layer_helper import LayerHelper
from ... import layers, unique_name

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial state of a decoder cell (reference
    beam_search_decoder.py:43). Either an explicit batch-sized `init`
    Variable, or a constant `value` whose batch size derives from
    `init_boot`."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the init batch size")
        else:
            d = (shape[-1] if shape else init_boot.shape[-1])
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=[-1, d], dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState(object):
    """Training-side state: a DynamicRNN memory (reference :100)."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _BeamState(object):
    """Generation-side state: a plain dense var, reordered by parent
    pointers between steps (replaces the reference's _ArrayState)."""

    def __init__(self, state_name, init_value):
        self._state_name = state_name
        self._value = init_value

    def get_state(self):
        return self._value

    def update_state(self, state):
        self._value = state


class StateCell(object):
    """Carrier of decode-step inputs/states (reference :159). Define the
    step with the `state_updater` decorator; both decoders invoke it via
    `compute_state`."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        self._cur_inputs = {}

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell has already entered a decoder")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder or self._cur_decoder_obj != decoder_obj:
            raise ValueError("not in this decoder")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        """Materialize per-decoder state holders lazily (reference
        :231)."""
        if not self._in_decoder:
            raise ValueError("not in a decoder block")
        if self._switched_decoder:
            raise ValueError("already switched")
        for state_name in self._state_names:
            if state_name not in self._states_holder:
                self._states_holder[state_name] = {}
            init = self._cur_states[state_name]
            if not isinstance(init, InitState):
                raise ValueError("state %s must start as InitState"
                                 % state_name)
            obj = self._cur_decoder_obj
            if obj.type == _DecoderType.TRAINING:
                holder = _MemoryState(state_name, obj.dynamic_rnn, init)
            else:
                holder = _BeamState(
                    state_name, obj._expand_to_beam(
                        init.value, reorder=init.need_reorder))
            self._states_holder[state_name][id(obj)] = holder
            self._cur_states[state_name] = holder.get_state()
        self._switched_decoder = True

    def state_updater(self, updater):
        """Decorator registering the one-step state transition
        (reference :314)."""
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell == self:
                raise TypeError("updater should only be called by decoders")
            updater(state_cell)

        return _decorator

    def get_state(self, state_name):
        if state_name not in self._cur_states:
            raise ValueError("unknown state %s" % state_name)
        cur = self._cur_states[state_name]
        if isinstance(cur, InitState):
            raise ValueError(
                "state %s read outside a decoder block" % state_name)
        return cur

    def get_input(self, input_name):
        if input_name not in self._cur_inputs:
            raise ValueError("unknown input %s" % input_name)
        return self._cur_inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def compute_state(self, inputs):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        self._cur_inputs = dict(inputs)
        if self._state_updater is None:
            raise ValueError("no state_updater registered")
        self._state_updater(self)

    def update_states(self):
        """Commit the step's new states back to their holders
        (reference :360)."""
        if not self._in_decoder:
            raise ValueError("update_states outside a decoder")
        obj_id = id(self._cur_decoder_obj)
        for state_name, holders in self._states_holder.items():
            holders[obj_id].update_state(self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder(object):
    """Train the cell over ragged target sequences (reference :384):
    a thin veneer over DynamicRNN whose memories are the cell states."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def block(self):
        """Context manager defining one timestep."""
        import contextlib

        @contextlib.contextmanager
        def _block():
            if self._status != TrainingDecoder.BEFORE_DECODER:
                raise ValueError("decoder.block() can only be invoked once")
            self._status = TrainingDecoder.IN_DECODER
            with self._dynamic_rnn.block():
                yield
            self._status = TrainingDecoder.AFTER_DECODER
            self._state_cell._leave_decoder(self)

        return _block()

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError("call TrainingDecoder after its block")
        return self._dynamic_rnn(*args, **kwargs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError("%s must be invoked inside block()" % method)


class BeamSearchDecoder(object):
    """Generate with beam search from a trained StateCell (reference
    :523). `decode()` builds the whole search; calling the decoder
    afterwards returns (translation_ids, translation_scores) as ragged
    LoD tensors.

    Dense redesign: rows = batch x beam_size throughout, parent pointers
    from the beam_search op reorder states (one gather per step), and
    the per-step selections stack into [T, B*W] tensors consumed by
    beam_search_decode — no TensorArray or While in the program.
    `emb_param_attr` / `score_param_attr` / `score_bias_attr` pin the
    embedding and scoring-fc parameter names for weight sharing with the
    training network."""

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None, emb_param_attr=None, score_param_attr=None,
                 score_bias_attr=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._state_cell = state_cell
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._max_len = max_len
        self._beam_size = beam_size
        self._end_id = end_id
        self._emb_param_attr = emb_param_attr
        self._score_param_attr = score_param_attr
        self._score_bias_attr = score_bias_attr
        self._sentence_ids = None
        self._sentence_scores = None
        # custom-block decode state (block/read_array/update_array)
        self._counter = None
        self._cond = None
        self._zero_idx = None
        self._array_dict = {}
        self._array_link = []
        self._ids_array = None
        self._scores_array = None

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    # -- dense-beam helpers ------------------------------------------------
    def _expand_to_beam(self, var, reorder=False):
        """[B, D] -> [B*W, D] by repeating each source row W times.
        (`reorder` kept for API parity; dense rows never need the
        reference's rank-table reordering.)"""
        W = self._beam_size
        if W == 1:
            return var
        e = layers.unsqueeze(var, axes=[1])                 # [B, 1, D]
        e = layers.expand(e, expand_times=[1, W] +
                          [1] * (len(var.shape) - 1))       # [B, W, ...]
        return layers.reshape(e, shape=[-1] + list(var.shape[1:]))

    def _dup_beam_mask(self, ref):
        """[B*W, 1] additive mask: 0 for slot 0 of each source, -1e9 for
        duplicate start beams (so step 0 expands one beam per source)."""
        W = self._beam_size
        ones = layers.fill_constant_batch_size_like(
            input=ref, shape=[-1, 1], value=1.0, dtype="float32")
        ramp = layers.cumsum(ones, axis=0, exclusive=True)
        slot = layers.elementwise_sub(
            ramp, layers.scale(
                layers.floor(layers.scale(ramp, scale=1.0 / W)),
                scale=float(W)))
        return layers.scale(layers.elementwise_min(slot, ones),
                            scale=-1e9)

    def decode(self):
        """Build the beam search (reference :652). Override for custom
        per-step behavior."""
        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("decode() can only be invoked once")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        cell = self._state_cell
        cell._enter_decoder(self)
        W = self._beam_size

        prev_ids = self._expand_to_beam(self._init_ids)
        prev_scores = self._expand_to_beam(self._init_scores)

        # feed vars expand once; reordered by parent pointers per step
        feed_vars = {}
        for name, var in self._input_var_dict.items():
            if name not in cell._inputs:
                raise ValueError(
                    "Variable %s not found in StateCell" % name)
            feed_vars[name] = self._expand_to_beam(var)

        step_ids, step_scores, step_parents = [], [], []
        first = True
        for _t in range(self._max_len):
            emb = layers.embedding(
                prev_ids, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=self._emb_param_attr)
            emb = layers.reshape(emb, shape=[-1, self._word_dim])
            feed_dict = {}
            for name in cell._inputs:
                feed_dict[name] = feed_vars.get(name, emb)
            cell.compute_state(inputs=feed_dict)
            out = cell.out_state()
            scores = layers.fc(out, size=self._target_dict_dim,
                               act="softmax",
                               param_attr=self._score_param_attr,
                               bias_attr=self._score_bias_attr)
            log_probs = layers.log(scores)
            accu = layers.elementwise_add(log_probs, prev_scores, axis=0)
            if first:
                first = False
                accu = layers.elementwise_add(
                    accu, self._dup_beam_mask(prev_scores), axis=0)
            sel_ids, sel_scores, parent = layers.beam_search(
                prev_ids, prev_scores, None, accu, beam_size=W,
                end_id=self._end_id, return_parent_idx=True)
            step_ids.append(sel_ids)
            step_scores.append(sel_scores)
            step_parents.append(parent)
            prev_ids, prev_scores = sel_ids, sel_scores
            # reorder every state and feed var by the surviving parents
            cell.update_states()
            obj_id = id(self)
            for state_name, holders in cell._states_holder.items():
                h = holders[obj_id]
                h.update_state(layers.gather(h.get_state(), parent))
                cell._cur_states[state_name] = h.get_state()
            for name in list(feed_vars):
                feed_vars[name] = layers.gather(feed_vars[name], parent)

        ids_arr = layers.stack([layers.reshape(i, shape=[-1])
                                for i in step_ids], axis=0)
        scores_arr = layers.stack([layers.reshape(s, shape=[-1])
                                   for s in step_scores], axis=0)
        parents_arr = layers.stack(step_parents, axis=0)
        self._sentence_ids, self._sentence_scores = \
            layers.beam_search_decode(
                ids_arr, scores_arr, beam_size=W, end_id=self._end_id,
                parent_idx=parents_arr)
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        cell._leave_decoder(self)

    # -- custom-block decoding (reference :616-:800) ----------------------
    # decode() above is the canonical DENSE search; block() exposes the
    # reference's build-your-own-step contract: ops recorded inside run
    # once per generation step in a While owned by the decoder, with
    # TensorArrays threading per-step selections (force_host: the
    # reference's WhileOp ran a nested Executor per iteration,
    # while_op.cc:50, and so does the port's while).

    @contextlib.contextmanager
    def block(self):
        """Define custom per-step decode behavior (reference :616)."""
        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("block() can only be invoked once")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        self._state_cell._enter_decoder(self)
        self._counter = layers.zeros(shape=[1], dtype="int64")
        self._counter.stop_gradient = True
        max_len_var = layers.fill_constant([1], "int64", self._max_len)
        self._cond = layers.less_than(self._counter, max_len_var)
        self._zero_idx = layers.fill_constant([1], "int64", 0,
                                              force_cpu=True)
        while_op = layers.While(self._cond, force_host=True)
        with while_op.block():
            yield
            with layers.Switch() as switch:
                with switch.case(self._cond):
                    layers.increment(self._counter, value=1.0,
                                     in_place=True)
                    for value, array in self._array_link:
                        layers.array_write(value, i=self._counter,
                                           array=array)
                    layers.less_than(self._counter, max_len_var,
                                     cond=self._cond)
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        self._state_cell._leave_decoder(self)

    def early_stop(self):
        """Stop generation before max_len — a "break" (reference :646)."""
        self._assert_in_decoder_block("early_stop")
        layers.fill_constant(shape=[1], dtype="bool", value=0,
                             force_cpu=True, out=self._cond)

    def read_array(self, init, is_ids=False, is_scores=False):
        """Read this step's value of a loop-carried array; `init` seeds
        step 0 (reference :731)."""
        self._assert_in_decoder_block("read_array")
        if is_ids and is_scores:
            raise ValueError("an array cannot be both ids and scores")
        parent_block = self._parent_block()
        array = parent_block.create_var(
            name=unique_name.generate("beam_search_decoder_array"),
            dtype=init.dtype)
        parent_block.append_op(
            type="write_to_array",
            inputs={"X": [init], "I": [self._zero_idx]},
            outputs={"Out": [array]}, attrs={}, infer_shape=False)
        if is_ids:
            self._ids_array = array
        elif is_scores:
            self._scores_array = array
        read_value = layers.array_read(array=array, i=self._counter)
        self._array_dict[read_value.name] = array
        return read_value

    def update_array(self, array, value):
        """Store this step's `value` into the array `read_array` returned
        (written at counter+1 as the loop advances; reference :780)."""
        self._assert_in_decoder_block("update_array")
        array = self._array_dict.get(array.name)
        if array is None:
            raise ValueError("invoke read_array before update_array")
        self._array_link.append((value, array))

    def _parent_block(self):
        program = self._helper.main_program
        parent_idx = program.current_block().parent_idx
        if parent_idx < 0:
            raise ValueError("decoder block has no parent block")
        return program.block(parent_idx)

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_BEAM_SEARCH_DECODER:
            raise ValueError("%s must be invoked inside block()" % method)

    def __call__(self):
        if self._status != BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError("call BeamSearchDecoder after decode()")
        if self._sentence_ids is None and self._ids_array is None:
            # the symmetric misuse cases both get explicit messages —
            # returning (None, None) here would surface as an unrelated
            # error at the caller's fetch
            raise ValueError(
                "custom decoder block never marked an ids array — "
                "beam_search_decode needs both (mark the ids array with "
                "read_array(..., is_ids=True)%s)"
                % ("" if self._scores_array is None
                   else "; is_scores was marked"))
        if self._sentence_ids is None and self._ids_array is not None:
            if self._scores_array is None:
                raise ValueError(
                    "custom decoder block marked is_ids on a read_array "
                    "but never is_scores — beam_search_decode needs both "
                    "(mark the scores array with read_array(..., "
                    "is_scores=True))")
            # custom-block path: decode straight from the TensorArrays
            # (the op stacks list-valued inputs)
            self._sentence_ids, self._sentence_scores = \
                layers.beam_search_decode(
                    self._ids_array, self._scores_array,
                    beam_size=self._beam_size, end_id=self._end_id)
        return self._sentence_ids, self._sentence_scores
